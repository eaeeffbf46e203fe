from .fcm import (FCMResult, fcm, wfcm, fcm_batched, fcm_sweep,
                  membership_terms, pairwise_sqdist, soft_assign, hard_assign)
from .wfcmpb import wfcmpb
from .bigfcm import (BigFCMConfig, BigFCMDiagnostics, BigFCMResult,
                     bigfcm_fit, run_driver)
from .sampling import parker_hall_sample_size, thompson_sample_size

__all__ = [
    "FCMResult", "fcm", "wfcm", "fcm_batched", "fcm_sweep",
    "membership_terms", "pairwise_sqdist", "soft_assign", "hard_assign",
    "wfcmpb",
    "BigFCMConfig", "BigFCMDiagnostics", "BigFCMResult", "bigfcm_fit",
    "run_driver", "parker_hall_sample_size", "thompson_sample_size",
]
