"""The port's train step against the reference's (``repro.train``) on
the dense, moe and encdec families (MiniCPM-2B, Kimi K2, Whisper): the
gradients of the SMOKE loss (every leaf within 1e-5 × the global
gradient norm) and three AdamW steps from the same params (loss within
1e-5 relative each step, params within 1e-5 relative L2), with fp32
moments, with int8 moments and under ``grad_accum=2`` (the fp32
accumulation of two microbatches). The ssm and hybrid families are in
``test_torch_trainstep_ssm.py``, the other archs' gradients in
``test_torch_grads.py`` (each file well under a minute)."""
import pytest

from _torch_train import one_thread  # noqa: F401 (autouse)
from _torch_train import (check_grads, check_int8_optimizer_steps,
                          check_steps)

STEP_ARCHS = ("minicpm-2b", "kimi-k2-1t-a32b", "whisper-large-v3")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference(arch):
    check_steps(arch)


def test_train_steps_with_int8_moments_match_reference():
    """Kimi K2's SMOKE lm_head (64, 512) is the leaf whose moments
    quantize (a last axis that is a multiple of 256); it is held by the
    next test (see ``check_steps``)."""
    check_steps("kimi-k2-1t-a32b", quant=True)


def test_int8_optimizer_steps_match_reference_on_the_same_gradients():
    check_int8_optimizer_steps("kimi-k2-1t-a32b")


def test_grad_accum_matches_reference():
    check_steps("minicpm-2b", grad_accum=2)
