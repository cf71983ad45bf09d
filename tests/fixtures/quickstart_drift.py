"""How far the quickstart's 20-round curve drifts under float32
round-off alone: the readings behind the tolerances of
tests/test_torch_quickstart_curve.py. Needs jax (the JAX package's run
at XLA backend optimisation level 1 is one witness).

Each line is the largest difference, over the 20 rounds, between two
runs of the same settings, draws and initial parameters
(tests/fixtures/quickstart_jax.npz), on the host drivers:

  port vs JAX            the port (oneDNN convolutions) against the fixture
  port vs port           oneDNN against PyTorch's native convolutions
  native port vs JAX     the native-convolution port against the fixture
  JAX vs JAX             JAX at XLA level 1 against the fixture (default)

then the same rounds forced: each round of the port run from JAX's
state at its start (`protocol.gan_round` of both packages, JAX at level
1), against JAX's round: the largest metric and parameter differences.

    PYTHONPATH=src:tests python tests/fixtures/quickstart_drift.py
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import test_torch_quickstart_curve as curve  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

METRICS = ("disc_objective", "gen_objective")


def port_curve(fx, mkldnn):
    """The port's 20 rounds: {metric: (20,)}, and the FIDs."""
    with torch.backends.mkldnn.flags(enabled=mkldnn):
        hist = curve.run_port(fx)
    return ({m: np.asarray([r.metrics[m] for r in hist]) for m in METRICS},
            np.asarray([r.fid for r in hist if r.fid is not None]))


def jax_curve(fx, level):
    """The JAX package's 20 rounds at XLA backend optimisation `level`."""
    hist = curve.live_jax_rounds(fx, curve.ROUNDS, level)[3]
    return {m: np.asarray([r.metrics[m] for r in hist]) for m in METRICS}


def drift(a, b):
    return {m: float(np.abs(a[m] - b[m]).max()) for m in METRICS}


def main():
    torch.set_num_threads(1)
    fx = curve.load_fixture()
    ref = {m: fx[m] for m in METRICS}
    port, port_fid = port_curve(fx, True)
    native, native_fid = port_curve(fx, False)

    def rel(a, b):
        return float(np.abs(a / b - 1).max())
    print("port vs JAX        ", drift(port, ref), "FID",
          rel(port_fid, fx["fid"]))
    print("port vs port       ", drift(port, native), "FID",
          rel(port_fid, native_fid))
    print("native port vs JAX ", drift(native, ref), "FID",
          rel(native_fid, fx["fid"]))
    print("JAX vs JAX         ", drift(jax_curve(fx, 1), ref))

    metric, param = 0.0, 0.0
    for jm, port_m, port, ref in curve.forced_rounds(fx, curve.ROUNDS):
        metric = max(metric, max(abs(port_m[k] - jm[k]) for k in jm))
        param = max(param, max(
            float((x - y).abs().max()) for part in ("gen", "disc")
            for x, y in zip(tree_leaves(port[part]),
                            tree_leaves(ref[part]))))
    print(f"forced rounds      metrics {metric:.3e}, parameters "
          f"{param:.3e}")


if __name__ == "__main__":
    main()
