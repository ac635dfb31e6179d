"""Nothing the harness loads on its chip path has the top-level name of JAX
or of the JAX package (compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port."""
import os
import subprocess
import sys

from bench_port import spec

ROOT = os.path.dirname(spec.ROOT)

BLOCKER = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""


def _run(banned, body):
    code = f"BANNED = {banned!r}\n{BLOCKER}\n{body}"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_small_run_loads_no_jax():
    body = """
import time, torch
from bench_port import harness, spec
from bench_port.tests.small import small_cell
for name in ("visual-bulk", "audio-bulk"):
    cfg, mix = small_cell(name)
    harness.run(name, 3, 0.3, True, t_start=time.perf_counter(), device="cpu",
                config=cfg, mix=mix, log=lambda m: None)
for m in spec.names("metrics", ".py"):
    spec.metric(m)
spec.generator("closed_bulk")
import bench_port.run, bench_port.control
print(sorted({m.split(".")[0] for m in sys.modules} & set(harness.BANNED)))
"""
    assert _run(["jax", "jaxlib", "flax", "multimodal_deepfake_detection_tpu"],
                body).strip().endswith("[]")


def test_the_reference_loads_nothing_of_the_port():
    body = """
import bench_port.reference, bench_port.reference.xception, bench_port.reference.heads
import bench_port.reference.mfcc
print("ok")
"""
    banned = ["jax", "jaxlib", "flax", "multimodal_deepfake_detection_tpu",
              "multimodal_deepfake_detection_tpu_torch"]
    assert _run(banned, body).strip() == "ok"
