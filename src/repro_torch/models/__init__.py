"""`repro_torch.models` — the LM stack, counterpart of `repro.models`.

The decoder LM of the dense, MoE, SSM and hybrid families
(`transformer.DecoderLM` over `attention`, `layers`, `moe` and `mamba`),
the encoder–decoder (`encdec.EncDecLM`), and the parameter declarations
of every family (`params`, with `from_reference` carrying the
reference's weights across).  Torch ops only: the reference's LM stack
reaches no Pallas kernel.
"""
from . import attention, encdec, layers, mamba, moe, params, transformer
from .encdec import EncDecLM
from .transformer import DecoderLM

__all__ = ["DecoderLM", "EncDecLM", "attention", "encdec", "layers",
           "mamba", "moe", "params", "transformer"]
