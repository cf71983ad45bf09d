#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. device   the card's name and power limit (nvidia-smi); TF32 off for
              matmuls and cuDNN convolutions, so float32 means float32
  2. build    every kernel of the main paths (wavg, trimmed_wavg),
              compiled with nvcc from src/repro_torch/csrc/, one nvcc per
              source, all started together
  3. kernels  each kernel against its plain PyTorch version at the main
              paths' shapes and at edge shapes; timed with CUDA events
              beside its bound and, where one exists, a PyTorch library
              call; the trimmed mean keeps the honest rows' range
  4. check    small rounds on the card (kernels) and on the CPU (plain
              versions) from the same draws: one plain protocol round,
              one protocol round and one FedGAN round under a fault
              program with the trimmed mean
  5. train    two main paths on the full-width DCGAN (K=10, 64x64),
              through `Trainer.run`, each with the launch counts set to 0
              just before it and read just after:
              a. the protocol: 3 serial rounds and 3 parallel rounds with
                 best-channel scheduling at ratio 0.5; one wavg launch per
                 round, finite values, a moving discriminator, one FID
              b. hostile workers (dropout, free-riders, byzantine devices,
                 stragglers): 3 serial rounds with the trimmed mean (one
                 trimmed_wavg launch, no wavg launch each), 1 with
                 norm_clip and 1 with krum (one wavg launch each), then
                 FedGAN: 2 rounds without faults or reducer (two wavg
                 launches each) and 2 under the faults with the trimmed
                 mean (one trimmed_wavg launch each)
  6. profile  one more protocol round under torch.profiler: device-busy
              share and the kernels that take the most device time
The last two lines are the `kernels` JSON line and
{"ok": true, "device": {...}}.
"""
import concurrent.futures
import copy
import dataclasses
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
N_FEDGAN = 6_342_272            # FedGAN's payload: discriminator + generator
EDGE_N = (1, 3, 2048, 2049)
EDGE_K = (1, 7, 64)
TRIM_EDGE_K = (1, 2, 5, 13, 32, 64)   # every KMAX of the kernel
TRIM_EDGE = (0, 1, 3)
# The hostile-worker population of the full-width run.
HOSTILE = dict(n_devices=10, dropout_prob=0.1, n_free_riders=2,
               n_byzantine=2, byz_scale=10.0, straggler_factor=2.0, seed=0)


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


def check_trimmed(torch, ops):
    """The trimmed_wavg kernel against its plain version at the main
    paths' shapes and at edge shapes (dropped rows, duplicated rows,
    integer-valued rows whose ties the index rule breaks), the honest-
    range property, and timings at both main shapes. Returns the
    kernel's JSON entry (launches unset)."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def inputs(k, n, *, n_zero=0, ties=False):
        if ties:
            x = torch.randint(-2, 3, (k, n), generator=gen,
                              device="cuda").float()
        else:
            x = torch.randn((k, n), generator=gen, device="cuda")
        if k >= 3:
            x[k - 1] = x[k - 2]            # exact ties, as free-riders make
        w = torch.rand(k, generator=gen, device="cuda") + 0.5
        w[:n_zero] = 0.0
        return x, w

    cases = [((K_MAIN, N_MAIN), 2, 1, False), ((K_MAIN, N_FEDGAN), 1, 1,
                                                False)]
    cases += [((k, n), trim, k // 4, trim == 3) for k in TRIM_EDGE_K
              for n in EDGE_N for trim in TRIM_EDGE]
    max_err = {}
    for (k, n), trim, n_zero, ties in cases:
        x, w = inputs(k, n, n_zero=n_zero, ties=ties)
        out = ops.trimmed_average(x, w, trim=trim)
        torch.cuda.synchronize()
        ref = ops.trimmed_mean_ref(x, w, trim)
        torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
        max_err[(k, n, trim)] = float((out - ref).abs().max())
    print(f"trimmed_wavg matches its plain version at {len(cases)} shapes "
          f"(rtol {RTOL}, atol {ATOL}); max abs err "
          f"{max(max_err.values()):.3e}")

    x = torch.randn((K_MAIN, N_MAIN), generator=gen, device="cuda")
    x[8:] *= 10.0                          # 2 hostile rows of 10 N(0, 1)
    out = ops.trimmed_average(x, torch.ones(K_MAIN, device="cuda"), trim=2)
    honest = x[:8]
    if not bool(((out >= honest.amin(0)) & (out <= honest.amax(0))).all()):
        raise AssertionError("trimmed mean left the honest rows' range")
    print("trimmed_wavg keeps every coordinate inside the 8 honest rows' "
          "range (2 rows of 10x noise, trim=2)")

    timed = {}
    for n, trim in ((N_MAIN, 2), (N_FEDGAN, 1)):
        # three payloads, together past the 50 MB L2; all rows take part
        main = [(torch.randn((K_MAIN, n), generator=gen, device="cuda"),
                 torch.ones(K_MAIN, device="cuda")) for _ in range(3)]
        kernel_ms = time_ms(lambda x, w: ops.trimmed_average(x, w,
                                                             trim=trim),
                            main)
        plain_ms = time_ms(lambda x, w: ops.trimmed_mean_ref(x, w, trim),
                           main)
        pairs = min(trim, (K_MAIN - 1) // 2)
        n_bytes = (K_MAIN * n + K_MAIN + n) * 4
        # per column: 2 * pairs passes of K compares, K multiply-adds,
        # K adds of the weights, one divide
        ops_count = n * (2 * pairs * K_MAIN + 3 * K_MAIN + 1)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops_count / F32_FLOPS_PER_S * 1e3
        timed[n] = dict(ms=kernel_ms, plain_ms=plain_ms,
                        bound_ms=max(bytes_ms, ops_ms),
                        bound_by="bytes" if bytes_ms >= ops_ms
                        else "operations")
        print(f"trimmed_wavg K={K_MAIN} N={n} trim={trim}: kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms ({n_bytes} B, {ops_count} "
              f"ops); {bytes_ms / kernel_ms:.3f} of HBM peak; no single "
              f"PyTorch call computes it")
        del main
    return {"name": "trimmed_wavg", "route": "cuda",
            "source": "src/repro_torch/csrc/trimmed_wavg.cu",
            "replaces": "src/repro/kernels/robust_avg/kernel.py:68",
            "launches": None,
            "max_abs_err": max(max_err[(K_MAIN, N_MAIN, 2)],
                               max_err[(K_MAIN, N_FEDGAN, 1)]),
            **timed[N_MAIN], "library_ms": None,
            "fedgan_shape": {"n": N_FEDGAN, "trim": 1, **timed[N_FEDGAN]}}


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


def check_faulted_rounds_against_cpu(torch):
    """One protocol round and one FedGAN round on a small DCGAN under a
    fault program (dropout, a free-rider, a byzantine device, stragglers)
    with the trimmed mean, on the card and on the CPU from the same
    draws. Agreement to float32 round-off, or to one quantization step
    where a stochastic rounding flips: the weights are equal, so the
    trimmed mean's order statistics move by at most that step."""
    import numpy as np
    from repro_torch.configs import DCGANConfig, ProtocolConfig
    from repro_torch.core import faults, fedgan, protocol
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    from repro_torch.models import dcgan
    from repro_torch.models.specs import make_dcgan_spec
    from repro_torch.tree import tree_leaves

    cfg = DCGANConfig(nz=16, ngf=8, ndf=8, nc=3, image_size=16)
    spec = make_dcgan_spec(cfg)
    k = 6
    pcfg = ProtocolConfig(n_devices=k, n_d=2, n_g=2, sample_size=16,
                          server_sample_size=16, lr_d=1e-3, lr_g=1e-3)
    fcfg = faults.FaultConfig(n_devices=k, dropout_prob=0.25,
                              n_free_riders=1, n_byzantine=1,
                              straggler_factor=2.0)
    prog = faults.fault_program(fcfg)
    reducer = RobustConfig(method="trimmed_mean", trim=1)
    gen = torch.Generator().manual_seed(2)
    params = dcgan.gan_init(gen, cfg)
    data = torch.rand((k, 32, 16, 16, 3), generator=gen) * 2 - 1

    for name, make_state, round_fn, payload_fn in (
            ("protocol", protocol.make_train_state, protocol.gan_round,
             lambda st: st["disc"]),
            ("FedGAN", fedgan.make_fedgan_state, fedgan.fedgan_round,
             lambda st: {"gen": st["gen"], "disc": st["disc"]})):
        state0 = make_state(lambda g: params, pcfg, k, device="cpu")
        n_params = protocol.count_params(payload_fn(state0))
        # seed 1 drops one honest device: the byzantine device and the
        # free-rider take part, and 5 participants let one pair be trimmed
        draws = protocol.DrawSampler(spec, pcfg, seed=1, n_local=32,
                                     n_params=n_params, device="cpu",
                                     faults=fcfg)(0)
        weights = torch.tensor(np.where(prog.dropout_mask(draws.drop_u),
                                        0.0, 16.0), dtype=torch.float32)
        if int((weights > 0).sum()) != 5:
            raise AssertionError(f"expected 5 participants, {weights}")
        out = {}
        for dev in ("cpu", "cuda"):
            state = faults.attach_fault_state(
                make_state(lambda g: params, pcfg, k, device=dev), fcfg,
                payload_fn)
            moved = protocol.RoundDraws(*(
                t.to(dev) if isinstance(t, torch.Tensor) else t
                for t in (getattr(draws, f.name)
                          for f in dataclasses.fields(draws))))
            out[dev] = round_fn(spec, pcfg, state, data.to(dev),
                                weights.to(dev), moved, faults=fcfg,
                                reducer=reducer)
        torch.cuda.synchronize()
        (s_cpu, m_cpu), (s_gpu, m_gpu) = out["cpu"], out["cuda"]
        # the uploaded nets to one quantization step, the protocol's
        # generator (trained on the server, never quantized) to round-off
        for part in ("gen", "disc"):
            quantized = part == "disc" or name == "FedGAN"
            for a, b in zip(tree_leaves(s_cpu[part]),
                            tree_leaves(s_gpu[part])):
                step = float(a.abs().max()) / 32767
                torch.testing.assert_close(
                    b.cpu(), a, rtol=0,
                    atol=step + 1e-6 if quantized else 1e-5)
        for key in m_cpu:
            torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=0,
                                       atol=1e-5)
        print(f"small {name} round under faults with the trimmed mean on "
              f"the card matches the CPU round (weights "
              f"{weights.tolist()})")


def train_hostile(torch, wavg_ops, robust_ops, spec, cfg, shards):
    """The hostile-worker path at full width: faults and robust reducers
    for the protocol, then FedGAN. Returns the launch counts of the
    path's run, {"wavg": n, "trimmed_wavg": n}."""
    import numpy as np
    from repro_torch.configs import ProtocolConfig
    from repro_torch.core import Trainer
    from repro_torch.core.faults import FaultConfig
    from repro_torch.kernels.robust_avg.ops import RobustConfig
    from repro_torch.models import dcgan
    from repro_torch.tree import tree_leaves

    pcfg = ProtocolConfig(n_devices=10, n_d=5, n_g=5, sample_size=128,
                          server_sample_size=128, optimizer="adam",
                          schedule="serial", scheduler="all")
    hostile = FaultConfig(**HOSTILE)
    runs = [  # (algorithm, faults, reducer, rounds, (wavg, trimmed) a round)
        ("proposed", hostile, RobustConfig("trimmed_mean", trim=2), 3,
         (0, 1)),
        ("proposed", hostile, RobustConfig("norm_clip"), 1, (1, 0)),
        ("proposed", hostile, RobustConfig("krum", krum_f=2), 1, (1, 0)),
        ("fedgan", None, None, 2, (2, 0)),
        ("fedgan", hostile, RobustConfig("trimmed_mean", trim=2), 2, (0, 1)),
    ]
    wavg_ops.launches = robust_ops.launches = 0   # the path starts here
    for algorithm, faults, reducer, n_rounds, per_round in runs:
        trainer = Trainer(spec, pcfg, lambda g: dcgan.gan_init(g, cfg),
                          shards, seed=1, algorithm=algorithm, faults=faults,
                          reducer=reducer)
        label = (f"{algorithm}/{reducer.method if reducer else 'mean'}"
                 f"{'' if faults else ' (no faults)'}")
        for _ in range(n_rounds):
            before = (wavg_ops.launches, robust_ops.launches)
            disc0 = copy.deepcopy(trainer.state["disc"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = trainer.run(1)[-1]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = (wavg_ops.launches - before[0],
                   robust_ops.launches - before[1])
            if got != per_round:
                raise AssertionError(f"{label} round {rec.round}: (wavg, "
                                     f"trimmed_wavg) launches {got}, "
                                     f"expected {per_round}")
            if not all(np.isfinite(v) for v in rec.metrics.values()):
                raise AssertionError(f"non-finite objectives {rec.metrics}")
            if not all(bool(torch.isfinite(x).all())
                       for x in tree_leaves(trainer.state)
                       if x.is_floating_point()):
                raise AssertionError(f"{label}: non-finite parameters")
            moved = max(float((a - b).abs().max()) for a, b in
                        zip(tree_leaves(disc0),
                            tree_leaves(trainer.state["disc"])))
            if not moved > 0:
                raise AssertionError(f"{label}: the discriminator did not "
                                     f"change")
            objective = rec.metrics.get("disc_objective")
            print(f"hostile {label:28s} round {rec.round}: "
                  + (f"D {objective:+.5f}  " if objective is not None
                     else "")
                  + f"weights {rec.weights.tolist()}  disc moved "
                  f"{moved:.3e}  {secs:.3f} s")
    launches = {"wavg": wavg_ops.launches,            # ... and ends here
                "trimmed_wavg": robust_ops.launches}
    want = {"wavg": sum(r[3] * r[4][0] for r in runs),
            "trimmed_wavg": sum(r[3] * r[4][1] for r in runs)}
    if launches != want:
        raise AssertionError(f"hostile path launches {launches}, expected "
                             f"{want}")
    print(f"hostile path: {launches['wavg']} wavg and "
          f"{launches['trimmed_wavg']} trimmed_wavg launches")
    return launches


def train(torch, ops, robust_ops):
    """The protocol's path: Trainer.run on the full DCGAN, both
    schedules. Returns its wavg launches, the last trainer and the
    (spec, cfg, shards) that the hostile path reuses."""
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

    ops.launches = robust_ops.launches = 0  # the path starts here
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
    if launches != 2 * 3 or robust_ops.launches != 0:
        raise AssertionError(f"{launches} wavg and {robust_ops.launches} "
                             f"trimmed_wavg launches over 6 rounds")

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
    return launches, trainer, (spec, cfg, shards)


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
    from repro_torch.kernels.robust_avg import ops as robust_ops
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

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(lambda m: m.build(), (ops, robust_ops)))
    print(f"built wavg and trimmed_wavg in {time.perf_counter() - t0:.2f} s")

    # 3. kernels
    wavg = check_wavg(torch, ops)
    trimmed = check_trimmed(torch, robust_ops)

    # 4. small rounds, card vs CPU
    check_round_against_cpu(torch)
    check_faulted_rounds_against_cpu(torch)

    # 5. train: the protocol's path, then the hostile-worker path
    protocol_launches, trainer, setup = train(torch, ops, robust_ops)
    hostile = train_hostile(torch, ops, robust_ops, *setup)
    wavg["launches"] = protocol_launches + hostile["wavg"]
    wavg["launches_by_path"] = {"protocol": protocol_launches,
                                "hostile": hostile["wavg"]}
    trimmed["launches"] = hostile["trimmed_wavg"]
    trimmed["launches_by_path"] = {"protocol": 0,
                                   "hostile": hostile["trimmed_wavg"]}

    # 6. where a round's time goes
    profile_round(torch, trainer)

    print(json.dumps({"kernels": [wavg, trimmed]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
