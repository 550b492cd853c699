"""The benchmark of knode_cosserat_tpu_torch, the PyTorch and CUDA port:
one cell, one run.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the CUDA cards the cell
asks for, and exits non-zero without a result where there are none. The
last line on standard output is the result's JSON object; the numbers the
check compared, each beside its limit, are the last lines on standard
error. The kernels' build, Triton's cache and CUDA's JIT cache live in
fixed directories under ``build/`` in the checkout, so only a checkout's
first run builds.
"""
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
