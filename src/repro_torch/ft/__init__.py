"""Fault tolerance (counterpart of ``repro.ft``): seeded fault
injection, per-query budgets, retry with backoff, admission control,
health probes and the degradation ladder for serving, and the
restartable trainer (``elastic.py``) for training."""
from .admission import UNBOUNDED, AdmissionPolicy
from .budget import UNLIMITED, Budget
from .degrade import Rung, engage, ladder, rung_for_attempt
from .elastic import FailAt, RestartableTrainer
from .health import StepWatchdog, check_devices
from .inject import (FaultPlan, FaultSpecError, ShardLossError, active,
                     faults)
from .retry import RetryPolicy, backoff_ms, with_retry

__all__ = [
    "AdmissionPolicy", "UNBOUNDED",
    "Budget", "UNLIMITED",
    "Rung", "engage", "ladder", "rung_for_attempt",
    "FailAt", "RestartableTrainer",
    "StepWatchdog", "check_devices",
    "FaultPlan", "FaultSpecError", "ShardLossError", "active", "faults",
    "RetryPolicy", "backoff_ms", "with_retry",
]
