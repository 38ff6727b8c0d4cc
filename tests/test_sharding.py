"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

import jax

from mp3tpu.models import layer3
from mp3tpu.parallel import sharding


@pytest.mark.slow
def test_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@pytest.mark.slow
def test_sharded_matches_chunked_single_device():
    """The sharded encode must agree with a single-device run that
    feeds the same 8-granule chunks with explicit 4-block halos and
    warmup=2 (the exact computation each shard performs, with ppermute
    replaced by host slicing).  This isolates the halo-exchange logic
    from float32 batch-shape jitter: shapes match, so any disagreement
    beyond XLA's shard_map-vs-jit fusion noise is a sharding bug."""
    from mp3tpu.ops import jaxloop
    from mp3tpu.tables import mpeg
    import jax.numpy as jnp

    n = 8
    per = 8
    G = per * n
    # low-level stationary signal: no attacks -> FSM stays NORM
    tt = np.arange(G * 576) / 44100.0
    x = (1500 * np.sin(2 * np.pi * 200.0 * tt)).astype(np.float32)
    blocks = x.reshape(G, 576)
    budget = np.full(G, 900.0, np.float32)

    ix_chunks, p23_chunks, pe_chunks = [], [], []
    ST = jaxloop._static(1, 0)
    for s in range(n):
        pos = per * s
        halo4 = (np.zeros((4, 576), np.float32) if s == 0
                 else blocks[pos - 4: pos])
        ext = np.concatenate([halo4[2:4], blocks[pos: pos + per]])
        ana = layer3._analyze_chunk_body(
            jnp.asarray(ext), jnp.asarray(halo4[0:2]),
            jnp.zeros((), jnp.int32), 44100.0)
        out = jaxloop.outer_loop(
            ana["xr"], jnp.asarray(budget[pos: pos + per]),
            ana["ratio_l"], ana["ratio_s"],
            ana["block_type"] != mpeg.NORM_TYPE, ana["block_type"], ST)
        ix = jnp.where((ana["xr"] < 0) & (out["ix"] > 0), -out["ix"],
                       out["ix"])
        ix_chunks.append(np.asarray(ix))
        p23_chunks.append(np.asarray(out["part2_3_length"]))
        pe_chunks.append(np.asarray(ana["pe"]))
    ix_ref = np.concatenate(ix_chunks)
    p23_ref = np.concatenate(p23_chunks)
    pe_ref = np.concatenate(pe_chunks)

    mesh = sharding.make_mesh(devices=jax.devices()[:n])
    out = sharding.encode_sharded(mesh, blocks, budget, 1, 0, 44100.0)
    ix_sh = np.asarray(out["ix"])
    p23_sh = np.asarray(out["part2_3_length"])

    # shard_map and jit may fuse float32 reductions differently; the
    # residual jitter (~4e-9 in xr) can flip nint() on coefficients at
    # the noise floor, so allow a tiny mismatch budget -- but any sign
    # error or search divergence would blow well past it
    coef_match = (ix_ref == ix_sh).mean()
    assert coef_match > 0.999, coef_match
    mism = ix_ref != ix_sh
    assert np.abs(ix_ref[mism] - ix_sh[mism]).max(initial=0) <= 1
    assert np.abs(p23_ref.astype(np.int64) - p23_sh).max() <= 16
    np.testing.assert_allclose(np.asarray(out["pe"]), pe_ref,
                               rtol=1e-4, atol=1e-3)

    # device-count invariance of the psy outputs at shard boundaries
    # (warmup=0 once made each shard's first 2 granules see zeroed
    # FFT history, so pe depended on the device count)
    # n=1 runs one (64,576) psy batch vs n=8's (10,576) chunks:
    # different batch shapes fuse differently in f32, giving ~1e-3
    # relative jitter in pe (see module docstring caveat); the old
    # warmup=0 bug produced order-of-magnitude boundary errors
    mesh1 = sharding.make_mesh(devices=jax.devices()[:1])
    out1 = sharding.encode_sharded(mesh1, blocks, budget, 1, 0, 44100.0)
    np.testing.assert_allclose(np.asarray(out["pe"]),
                               np.asarray(out1["pe"]),
                               rtol=5e-3, atol=1e-2)
