"""Write tests/fixtures/quickstart_jax.npz: the JAX package's quickstart
run (`examples/quickstart.py`'s settings: reduced DCGAN 32x32, K=10,
serial schedule, Adam, 16-bit uplink, 20 rounds, FID every 5 rounds) on
its host driver, and everything the port needs to repeat it without
jax:

  gen_%03d, disc_%03d   the initial parameters, leaves in the JAX tree
                        order (the port's `tree_leaves` order)
  z_dev, z_srv, idx     each round's shared noise and sample indices
                        (R, n_d, m, nz), (R, n_g, M, nz), (R, n_d, K, m)
  uplink_keys           (R, K, 2) uint32: device k's uplink-quantizer
                        key of round t (`quantize.device_uplink_key`);
                        the test draws the uniforms from them with a
                        numpy threefry2x32, since (R, K, N) uniforms
                        would take 34 MB
  fid_w0, fid_w1, fid_w2  the FID feature extractor's weights
  fid_z, fid_rounds     the 256 generator draws of each FID round
  mask, wallclock_s, cumulative_s, disc_objective, gen_objective,
  participation, fid    the run's curve

The host driver's channel and scheduler are numpy, so the port's host
driver repeats its masks and wallclock bit for bit; the fused drivers
draw fading from each package's own streams. Nothing is downloaded.

    PYTHONPATH=src python tests/fixtures/make_quickstart_fixture.py
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import ProtocolConfig
from repro.configs.dcgan import DCGANConfig
from repro.core import Trainer, protocol, quantize
from repro.data import make_image_dataset, partition
from repro.metrics import fid_score, make_feature_extractor
from repro.models import dcgan
from repro.models.specs import make_dcgan_spec

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "quickstart_jax.npz")
ROUNDS, K, EVAL_EVERY, SEED = 20, 10, 5, 0
CFG = DCGANConfig(nz=32, ngf=16, ndf=16, nc=3, image_size=32)
PCFG = ProtocolConfig(n_devices=K, n_d=2, n_g=2, sample_size=16,
                      server_sample_size=16, lr_d=2e-4, lr_g=2e-4,
                      schedule="serial", optimizer="adam")


def fid_weights(channels, feat_dim=64, seed=42):
    """The weights `repro.metrics.fid.make_feature_extractor` draws."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    shapes = [(4, 4, channels, 16), (4, 4, 16, 32), (4, 4, 32, feat_dim)]
    return [np.asarray(jax.random.normal(k, s)) / d
            for k, s, d in zip(ks, shapes, (4.0, 8.0, 16.0))]


def round_draws(key, t, n_local):
    """Round t's draws as the JAX host driver takes them from
    fold_in(key, t) (`protocol.gan_round`'s salts)."""
    rk = jax.random.fold_in(key, t)
    salted_z = jax.random.fold_in(rk, protocol._SALT_SHARED_Z)
    salted_x = jax.random.fold_in(rk, protocol._SALT_DATA)
    z = lambda j, n: np.asarray(jax.random.normal(
        jax.random.fold_in(salted_z, j), (n, CFG.nz)))
    z_dev = np.stack([z(j, PCFG.sample_size) for j in range(PCFG.n_d)])
    z_srv = np.stack([z(j, PCFG.server_sample_size)
                      for j in range(PCFG.n_g)])
    idx = np.stack([[np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(salted_x, k), j),
        (PCFG.sample_size,), 0, n_local)) for k in range(K)]
        for j in range(PCFG.n_d)])
    keys = np.stack([np.asarray(jax.random.key_data(
        quantize.device_uplink_key(rk, k))) for k in range(K)])
    return z_dev, z_srv, idx, keys.astype(np.uint32)


def main():
    key = jax.random.PRNGKey(SEED)
    imgs, _ = make_image_dataset("celeba32", 640)
    shards = jnp.asarray(partition(imgs, K))
    weights = fid_weights(CFG.nc)
    feat = make_feature_extractor(CFG.nc)
    real_feats = feat(jnp.asarray(imgs[:512]))
    fid_z = []

    def fid_fn(gen_params, fid_key):
        z = jax.random.normal(fid_key, (256, CFG.nz))
        fid_z.append(np.asarray(z))
        return fid_score(real_feats,
                         feat(dcgan.generator_apply(gen_params, CFG, z)))

    trainer = Trainer(make_dcgan_spec(CFG, gen_loss_variant="nonsaturating"),
                      PCFG, lambda k: dcgan.gan_init(k, CFG), shards, key,
                      driver="host")
    out = {}
    for part in ("gen", "disc"):
        for i, leaf in enumerate(jax.tree_util.tree_leaves(
                trainer.state[part])):
            out[f"{part}_{i:03d}"] = np.asarray(leaf)
    hist = trainer.run(ROUNDS, eval_every=EVAL_EVERY, fid_fn=fid_fn)
    draws = [round_draws(key, t, shards.shape[1]) for t in range(ROUNDS)]
    for name, arrays in zip(("z_dev", "z_srv", "idx", "uplink_keys"),
                            zip(*draws)):
        out[name] = np.stack(arrays)
    out["idx"] = out["idx"].astype(np.int16)
    for i, w in enumerate(weights):
        out[f"fid_w{i}"] = w
    out["fid_z"] = np.stack(fid_z)
    out["fid_rounds"] = np.asarray([r.round for r in hist
                                    if r.fid is not None])
    out["fid"] = np.asarray([r.fid for r in hist if r.fid is not None])
    out["mask"] = np.stack([r.mask for r in hist])
    out["wallclock_s"] = np.asarray([r.wallclock_s for r in hist])
    out["cumulative_s"] = np.asarray([r.cumulative_s for r in hist])
    for name in hist[0].metrics:
        out[name] = np.asarray([r.metrics[name] for r in hist], np.float32)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes; FID "
          f"{out['fid'].tolist()} at rounds {out['fid_rounds'].tolist()}")


if __name__ == "__main__":
    main()
