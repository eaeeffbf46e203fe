from .fcm import (FCMResult, fcm, wfcm, fcm_batched, fcm_sweep,
                  membership_terms, pairwise_sqdist, soft_assign, hard_assign)
from .outofcore import (StagingRing, make_accumulator, ooc_accumulate,
                        ooc_fcm, ooc_sweep)
from .wfcmpb import wfcmpb, wfcmpb_batches, wfcmpb_store
from .bigfcm import (BigFCMConfig, BigFCMDiagnostics, BigFCMResult,
                     bigfcm_fit, bigfcm_fit_store, driver_seeds, run_driver)
from .sampling import parker_hall_sample_size, thompson_sample_size

__all__ = [
    "FCMResult", "fcm", "wfcm", "fcm_batched", "fcm_sweep",
    "membership_terms", "pairwise_sqdist", "soft_assign", "hard_assign",
    "StagingRing", "make_accumulator", "ooc_accumulate", "ooc_fcm",
    "ooc_sweep", "wfcmpb", "wfcmpb_batches", "wfcmpb_store",
    "BigFCMConfig", "BigFCMDiagnostics", "BigFCMResult", "bigfcm_fit",
    "bigfcm_fit_store", "driver_seeds", "run_driver",
    "parker_hall_sample_size", "thompson_sample_size",
]
