"""chip_smoke.py off the card: it refuses to run without a GPU, and its
exact-integer and front-end phases hold at small sizes on the CPU.

The full-size run is `python chip_smoke.py` on the GPU; the `gpu`
tests below repeat phases 5 and 6 at full width there
(JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py).
"""
import importlib.util
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0, r.stdout
    assert '"ok"' not in r.stdout, r.stdout
    assert "needs a GPU" in r.stderr, r.stderr


def test_seeded_batch_covers_value_classes():
    ix, is_short, is_short_block = cs.seeded_quantized(512)
    assert (ix == 0).all(axis=1).any()             # silent granules
    assert (ix > 15).any() and (ix > 8206).any()   # ESC and out of range
    assert ((ix == 1) & (np.roll(ix, 1, axis=1) == 0)).any()  # count1
    assert is_short.any() and (is_short_block & ~is_short).any()


@pytest.mark.parametrize("G", [16, 256])
def test_integers_phase_on_cpu(G):
    cpu = jax.devices("cpu")[0]
    assert cs.phase_integers("cpu", G=G, dev=cpu, ref_dev=cpu, reps=1) > 0


def test_frontend_phase_on_cpu():
    cpu = jax.devices("cpu")[0]
    assert cs.phase_frontend("cpu", G=64, dev=cpu) <= cs.XR_TOL


@pytest.mark.gpu
def test_integers_phase_full_width(gpu):
    cs.phase_integers("gpu", G=4096, dev=gpu, ref_dev=jax.devices("cpu")[0])


@pytest.mark.gpu
def test_frontend_phase_full_width(gpu):
    assert cs.phase_frontend("gpu", G=2048, dev=gpu) <= cs.XR_TOL
