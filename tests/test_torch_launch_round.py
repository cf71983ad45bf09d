"""Port parity: one bfloat16 round of the launch layer's stacked train
step against the JAX package's `protocol.gan_round` on reduced
granite-3-2b at seq_len 520, where attention takes the flash branch
(`round_matches_jax` and its tolerances: tests/test_torch_launch_steps.py).
"""
import pytest

pytest.importorskip("jax")

from test_torch_launch_steps import round_matches_jax
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name,seq", [("granite-3-2b", 520)])
def test_bf16_round_matches_jax_gan_round(name, seq):
    round_matches_jax(name, seq)
