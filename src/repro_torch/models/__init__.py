"""`repro_torch.models` — the LM stack, counterpart of `repro.models`.

The dense decoder (`transformer.DecoderLM` over `attention` and
`layers`), the parameter declarations of every family (`params`, with
`from_reference` carrying the reference's weights across), and the
declarations alone of the MoE, Mamba2 and encoder–decoder families,
whose layers are ROADMAP Queue 1 item 3b.  Torch ops only: the
reference's LM stack reaches no Pallas kernel.
"""
from . import attention, encdec, layers, mamba, moe, params, transformer
from .transformer import DecoderLM

__all__ = ["DecoderLM", "attention", "encdec", "layers", "mamba", "moe",
           "params", "transformer"]
