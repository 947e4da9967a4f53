"""Training of the hybrid and audio families (zamba2-1.2b,
whisper-small) against the reference, on the CPU, and the ssm family's
overfit (mamba2-130m).

The loss, every gradient leaf, one train step and the reference's
four-step overfit at ``with_reduced(dtype="float32")`` (cases and
tolerances: ``tests/torch_train_parity.py``; mamba2-130m's loss,
gradients and step are held in ``tests/test_torch_train.py``, its
overfit here).  Reduced zamba2 applies its shared block after layer 1
(``attn_period`` 2); reduced whisper takes 32 random frames, so its
encoder's every leaf carries gradient.
"""

import pytest

from torch_train_parity import (check_loss_and_grads, check_overfit,
                                check_train_step, pair)

ARCHS = ("zamba2-1.2b", "whisper-small")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return pair(request.param)


def test_loss_and_grads_match_reference(model):
    check_loss_and_grads(model)


def test_train_step_matches_reference(model):
    check_train_step(model)


@pytest.mark.parametrize("arch", ("mamba2-130m",) + ARCHS)
def test_overfit_matches_reference(arch):
    check_overfit(pair(arch))
