"""The port's training loss and gradients against the reference's, as in
``tests/test_torch_train_loss.py``, for the prefix (phi3-vision), MoE
(Grok-1, Llama-4 Scout), Mamba-2 (Zamba2, whose shared block runs once a
group) and xLSTM smoke configs.  On the CPU K10 runs its plain version,
which torch differentiates; on the card K10 has no backward yet and
raises under autograd (ROADMAP queue 1, item 12i)."""

import pytest

from _torch_train_ref import one_torch_thread  # noqa: F401 (autouse)
from test_torch_train_loss import check_loss_and_grads

ARCHS = ("phi3_vision_4p2b", "grok1_314b", "llama4_scout_17b_a16e",
         "zamba2_7b", "xlstm_1p3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    check_loss_and_grads(arch)
