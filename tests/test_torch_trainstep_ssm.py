"""The port's train step against the reference's on the ssm and hybrid
families (Mamba2-780m, Zamba2-2.7B at SMOKE): gradients within 1e-5 ×
the global gradient norm, three AdamW steps within 1e-5 (the checks of
``test_torch_trainstep.py``, split off to keep each file short)."""
import pytest

from _torch_train import one_thread  # noqa: F401 (autouse)
from _torch_train import check_grads, check_steps

STEP_ARCHS = ("mamba2-780m", "zamba2-2.7b")


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_gradients_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_reference(arch):
    check_steps(arch)
