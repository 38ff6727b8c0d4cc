"""Multi-chip scaling: granule-axis sharding over a device mesh.

The reference is strictly sequential (SURVEY.md section 2.3); its
carried state S1-S3 (filterbank ring buffer, MDCT overlap, psy FFT
history) are fixed-size halos at shard boundaries, exchanged with the
left neighbor via ppermute.  The bit reservoir (S4/S5) is a
scalar prefix dependency handled by the host scan in mp3tpu.encoder;
its per-shard inputs (pe, demand) come back with the encode outputs.

Layout: the granule axis is sharded contiguously over the mesh axis
"frames".  Each shard needs the 2 sample-blocks (1152 samples)
preceding its range -- exactly the psy savebuf + filterbank window
reach -- which is what the halo exchange provides.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import jaxdsp, jaxloop, jaxpsy
from ..tables import mpeg


def make_mesh(n_devices=None, devices=None):
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devices), ("frames",))


def encode_sharded(mesh, blocks, budget, version, sampling_frequency,
                   sfreq_hz):
    """Granule-parallel encode over the mesh.

    blocks: (G, 576) float32, G divisible by mesh size.
    budget: (G,) float32 per-granule bit budgets.
    Returns the per-granule coding decision dict (sharded outputs).
    """
    ST = jaxloop._static(version, sampling_frequency)
    per = blocks.shape[0] // mesh.devices.size
    assert per >= 4, (
        f"encode_sharded needs >= 4 granules per shard for the 4-block "
        f"psy halo exchange (got {per}); use fewer devices or the "
        f"chunked path (parallel/clip.py)")

    def shard_fn(blocks_s, budget_s):
        # halo: receive the last 4 blocks of the LEFT neighbor -- rows
        # 0:2 are the psy FFT-history halo, rows 2:4 are in-batch
        # warmup granules (the psy unpredictability/pre-echo chains
        # reach 2 granules back, see jaxpsy.psycho_granules), so each
        # shard's boundary granules see the exact same state a
        # whole-clip batch computes and output is device-count
        # invariant (same scheme as parallel/clip.py analyze_fn).
        axis = "frames"
        n = jax.lax.axis_size(axis)
        idx = jax.lax.axis_index(axis)
        tail = blocks_s[-4:]
        halo = jax.lax.ppermute(tail, axis,
                                [(i, (i + 1) % n) for i in range(n)])
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)

        blocks_ext = jnp.concatenate([halo[2:4], blocks_s])
        psy = jaxpsy.psycho_granules(blocks_ext, halo[0:2], sfreq_hz,
                                     warmup=2)
        scaled = blocks_ext / 32768.0
        sb = jaxdsp.subband_granules(scaled[2:], scaled[1, 64:])
        sb_prev = jaxdsp.subband_granules(scaled[1][None],
                                          scaled[0, 64:])[0]
        xr = jaxdsp.mdct_granules(sb, sb_prev, psy["block_type"])
        is_short_block = psy["block_type"] != mpeg.NORM_TYPE
        out = jaxloop.outer_loop(xr, budget_s, psy["ratio_l"],
                                 psy["ratio_s"], is_short_block,
                                 psy["block_type"], ST)
        # reapply spectrum signs (l3bitstream.c:114-126), same as
        # models.layer3.encode_granules
        out["ix"] = jnp.where((xr < 0) & (out["ix"] > 0), -out["ix"],
                              out["ix"])
        out["pe"] = psy["pe"]
        out["xr"] = xr
        # a cheap cross-shard reduction exercises the collective path and
        # gives the host scan a global bit-demand estimate up front
        out["total_demand"] = jax.lax.psum(
            jnp.sum(out["part2_3_length"]), axis)[None]
        return out

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P("frames"), P("frames")),
        out_specs={k: P("frames") for k in
                   ("ix", "qss", "qss0", "bits", "part2", "compress", "sf_l",
                    "sf_s", "preflag", "count1", "big_values", "r0",
                    "r1", "a1", "a2", "table_select",
                    "count1table_select", "part2_3_length",
                    "global_gain", "block_type",
                    "window_switching_flag", "pe", "xr")} |
                  {"total_demand": P("frames")},
    )
    return fn(blocks, budget)
