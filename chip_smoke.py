#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi); TF32 off for
              matmuls and cuDNN convolutions, so float32 means float32
  2. build    every kernel of the main path, compiled with nvcc from
              src/repro_torch/csrc/
  3. kernels  each kernel against its plain PyTorch version at the main
              path's shape and at edge shapes; timed with CUDA events
              beside its bound and one PyTorch library call
  4. check    one protocol round on a small DCGAN, on the card (kernel)
              and on the CPU (plain version) from the same draws
  5. train    the paper's protocol on the full-width DCGAN (K=10, 64x64):
              3 serial rounds and 3 parallel rounds with best-channel
              scheduling at ratio 0.5, through `Trainer.run`; one wavg
              launch per round, finite values, a moving discriminator,
              one FID
  6. profile  one more round under torch.profiler: device-busy share
              and the kernels that take the most device time
The last two lines are the `kernels` JSON line and
{"ok": true, "device": {...}}.
"""
import copy
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: HBM bandwidth and the float32 rate outside
# the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

RTOL, ATOL = 1e-5, 1e-6        # f32 sums of K terms in another order
K_MAIN, N_MAIN = 10, 2_765_568  # Algorithm 2 on the DCGAN discriminator
EDGE_N = (1, 3, 2048, 2049)
EDGE_K = (1, 7, 64)


def time_ms(fn, inputs, reps=20, per_rep=12, warmup=3):
    """Milliseconds per call of `fn`, by CUDA events: the median over
    `reps` samples, each the mean of `per_rep` back-to-back calls (so
    the host's launch latency overlaps the device's work). Call i takes
    inputs[i % len(inputs)]: distinct buffers, so no call finds its
    input left in L2 by the call before."""
    import torch
    for i in range(warmup):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(per_rep):
            fn(*inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return statistics.median(times)


def check_wavg(torch, ops):
    """Kernel vs plain version at every listed shape; timings at the
    main-path shape. Returns the kernel's JSON entry (launches unset)."""
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(k, n):
        x = torch.randn((k, n), generator=gen, device="cuda")
        w = torch.rand(k, generator=gen, device="cuda")
        return x, w / w.sum()

    shapes = [(K_MAIN, N_MAIN)] + [(k, n) for k in EDGE_K for n in EDGE_N]
    max_err = {}
    for k, n in shapes:
        x, w = inputs(k, n)
        out = ops.weighted_average(x, w)
        torch.cuda.synchronize()
        ref = ops.wavg_ref(x, w)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        max_err[(k, n)] = float((out - ref).abs().max())
    print(f"wavg matches its plain version at {len(shapes)} shapes "
          f"(rtol {RTOL}, atol {ATOL}); max abs err "
          f"{max(max_err.values()):.3e}")

    # three payloads of 110.6 MB each, together well past the 50 MB L2
    main = [inputs(K_MAIN, N_MAIN) for _ in range(3)]
    kernel_ms = time_ms(ops.weighted_average, main)
    plain_ms = time_ms(ops.wavg_ref, main)
    library_ms = time_ms(lambda x, w: torch.matmul(w, x), main)
    n_bytes = (K_MAIN * N_MAIN + K_MAIN + N_MAIN) * 4
    flops = 2 * K_MAIN * N_MAIN
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    print(f"wavg K={K_MAIN} N={N_MAIN}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, w @ x {library_ms:.4f} ms, bound "
          f"{max(bytes_ms, flops_ms):.4f} ms ({n_bytes} B); "
          f"{bytes_ms / kernel_ms:.3f} of HBM peak")
    return {"name": "wavg", "route": "cuda",
            "source": "src/repro_torch/csrc/wavg.cu",
            "replaces": "src/repro/kernels/wavg/kernel.py:31",
            "launches": None, "max_abs_err": max_err[(K_MAIN, N_MAIN)],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "library_ms": library_ms}


def check_round_against_cpu(torch):
    """One small protocol round on the card and on the CPU, same
    weights and draws: the card's round (wavg kernel, cuDNN) must agree
    with the CPU's (plain version) to float32 round-off, or to one
    quantization step where a stochastic rounding flips."""
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import protocol
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    from repro_torch.tree import tree_leaves

    cfg = DCGANConfig(nz=16, ngf=8, ndf=8, nc=3, image_size=16)
    spec = make_dcgan_spec(cfg)
    pcfg = ProtocolConfig(n_devices=4, n_d=2, n_g=2, sample_size=16,
                          server_sample_size=16, lr_d=1e-3, lr_g=1e-3)
    gen = torch.Generator().manual_seed(1)
    params = dcgan.gan_init(gen, cfg)
    data = torch.rand((4, 32, 16, 16, 3), generator=gen) * 2 - 1
    n_params = protocol.count_params(params["disc"])
    draws = protocol.DrawSampler(spec, pcfg, seed=1, n_local=32,
                                 n_params=n_params, device="cpu")(0)
    weights = torch.tensor([16.0, 0.0, 16.0, 16.0])

    out = {}
    for dev in ("cpu", "cuda"):
        state = protocol.make_train_state(lambda g: params, pcfg, 4,
                                          device=dev)
        moved = protocol.RoundDraws(
            *(None if t is None else t.to(dev) for t in
              (draws.z_dev, draws.z_srv, draws.idx, draws.quant_u)))
        out[dev] = protocol.gan_round(spec, pcfg, state, data.to(dev),
                                      weights.to(dev), moved)
    torch.cuda.synchronize()
    (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out["cuda"]
    for a, b in zip(tree_leaves(s_cpu["disc"]), tree_leaves(s_gpu["disc"])):
        step = float(a.abs().max()) / 32767
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=step + 1e-6)
    for a, b in zip(tree_leaves(s_cpu["gen"]), tree_leaves(s_gpu["gen"])):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=1e-5)
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].cpu(), m_cpu[k], rtol=0,
                                   atol=1e-5)
    print("small round on the card matches the CPU round "
          f"(D objective {float(m_gpu['disc_objective']):+.6f})")


def train(torch, ops):
    """The main path: Trainer.run on the full DCGAN, both schedules."""
    import numpy as np
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import Trainer, protocol
    from repro_torch.data import make_image_dataset, partition
    from repro_torch.metrics import fid_score, make_feature_extractor
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    from repro_torch.tree import tree_leaves

    cfg = DCGANConfig()
    spec = make_dcgan_spec(cfg, gen_loss_variant="nonsaturating")
    imgs, _ = make_image_dataset("celeba", 10 * 512, seed=0)
    shards = partition(imgs, 10)
    runs = [dict(schedule="serial", scheduler="all", scheduling_ratio=1.0),
            dict(schedule="parallel", scheduler="best_channel",
                 scheduling_ratio=0.5)]

    ops.launches = 0                       # the main path starts here
    trainer = None
    for run in runs:
        pcfg = ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                              server_sample_size=128, optimizer="adam", **run)
        trainer = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg),
                          shards, seed=0)
        n_gen = protocol.count_params(trainer.state["gen"])
        n_disc = protocol.count_params(trainer.state["disc"])
        if (n_gen, n_disc) != (3_576_704, 2_765_568):
            raise AssertionError(f"DCGAN sizes {n_gen}, {n_disc}")
        disc0 = copy.deepcopy(trainer.state["disc"])
        for r in range(3):
            before = ops.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = trainer.run(1)[-1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if ops.launches != before + 1:
                raise AssertionError(f"round {r}: {ops.launches - before} "
                                     f"wavg launches, expected 1")
            if not all(np.isfinite(v) for v in rec.metrics.values()):
                raise AssertionError(f"non-finite objectives {rec.metrics}")
            print(f"{run['schedule']:8s} round {rec.round}: "
                  f"D {rec.metrics['disc_objective']:+.5f}  "
                  f"G {rec.metrics['gen_objective']:+.5f}  "
                  f"weights {rec.weights.tolist()}  {secs:.3f} s")
        leaves = tree_leaves(trainer.state)
        if not all(bool(torch.isfinite(x).all()) for x in leaves
                   if x.is_floating_point()):
            raise AssertionError("non-finite parameters")
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(disc0),
                        tree_leaves(trainer.state["disc"])))
        if not moved > 0:
            raise AssertionError("the discriminator did not change")
        if run["scheduler"] == "best_channel":
            if not all((rec.weights == 0).sum() == 5
                       for rec in trainer.history):
                raise AssertionError("best_channel at 0.5 must drop 5 of 10")
        print(f"{run['schedule']}: {n_gen} G / {n_disc} D parameters, "
              f"discriminator moved by up to {moved:.3e}")
    launches = ops.launches                # ... and ends here
    if launches != 2 * 3:
        raise AssertionError(f"{launches} wavg launches over 6 rounds")

    feat = make_feature_extractor(cfg.nc)
    real = feat(torch.as_tensor(imgs[:512], device="cuda"))
    with torch.no_grad():
        z = torch.randn((256, cfg.nz), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        fake = dcgan.generator_apply(trainer.state["gen"], cfg, z)
    fid = fid_score(real, feat(fake))
    if not np.isfinite(fid):
        raise AssertionError(f"FID {fid}")
    print(f"FID after the last round: {fid:.4f}")
    return launches, trainer


def profile_round(torch, trainer):
    """Where a round's time goes: one more parallel round under
    torch.profiler (after the main path's launch count was read), its
    device-busy share and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(1)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not spans:
        print("profile: the profiler saw no device events; device busy "
              "share not measured")
        return
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted(spans):      # union of kernel intervals
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    print(f"profile of one round (profiler on): {wall_s:.3f} s wall, "
          f"{busy_us / 1e6:.3f} s device busy "
          f"({busy_us / 1e6 / wall_s:.3f}), {len(spans)} device ops")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.wavg import ops

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32 "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    ops.build()
    print(f"built wavg in {time.perf_counter() - t0:.2f} s")

    # 3. kernels
    wavg = check_wavg(torch, ops)

    # 4. small round, card vs CPU
    check_round_against_cpu(torch)

    # 5. train
    wavg["launches"], trainer = train(torch, ops)

    # 6. where a round's time goes
    profile_round(torch, trainer)

    print(json.dumps({"kernels": [wavg]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
