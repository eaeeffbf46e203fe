from .plane import geom_bucket, pad_rows
from .synth import make_blobs, make_higgs_like, make_kdd_like, make_susy_like

__all__ = ["geom_bucket", "pad_rows", "make_blobs", "make_higgs_like",
           "make_kdd_like", "make_susy_like"]
