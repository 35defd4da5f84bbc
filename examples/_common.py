"""Shared driver plumbing for the example mains (the per-frame timing
loop + median/mean report every Examples/*.cc main() performs)."""

import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# Persistent XLA compilation cache at a fixed path (repeated runs hit
# the cache), unless JAX_COMPILATION_CACHE_DIR already names one.
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    str(Path(__file__).resolve().parents[1] / ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

if os.environ.get("JAX_PLATFORMS"):
    # Apply the platform choice through the config as well as the env.
    import jax

    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def run_sequence(slam, n, step, label="frame"):
    """Drive `step(i) -> timestamp` over n frames, print timing report."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        step(i)
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            st = slam.tracker.stats[-1] if slam.tracker.stats else {}
            print(
                f"{label} {i}: state={slam.tracking_state()} "
                f"inliers={st.get('inliers', '-')} "
                f"kf={slam.map.n_keyframes()} {1e3 * times[-1]:.0f} ms"
            )
    slam.shutdown()
    t = np.array(times[2:]) if len(times) > 4 else np.array(times)
    if len(t):
        print(
            f"tracking time: median {1e3 * np.median(t):.1f} ms, "
            f"mean {1e3 * t.mean():.1f} ms"
        )
    print(f"loops closed: {slam.n_loops_closed}")
