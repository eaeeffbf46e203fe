from .synth import make_blobs, make_higgs_like, make_kdd_like, make_susy_like

__all__ = ["make_blobs", "make_higgs_like", "make_kdd_like", "make_susy_like"]
