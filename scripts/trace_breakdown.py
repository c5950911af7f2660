"""Op-level step breakdown from a jax.profiler device trace.

Profiles N train steps, then parses the perfetto trace proto (no
tensorboard needed) and aggregates device-op durations by HLO category —
the ground truth for where step time goes.

    python scripts/trace_breakdown.py                 # full train step, batch 16
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import re
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


TRACE_DIR = os.path.join(os.path.dirname(__file__), "..", "results", "trace")


def run_profiled_steps(batch_size=16, steps=5, **model_kwargs):
    from bench import make_batch
    from edrl.config import DataConfig, EDRLConfig, ModelConfig, TrainConfig
    from edrl.train.trainer import (
        init_state,
        make_model,
        make_optimizer,
        make_train_step,
    )

    cfg = EDRLConfig(
        data=DataConfig(batch_size=batch_size),
        model=ModelConfig(use_bfloat16=True, **model_kwargs),
        train=TrainConfig(),
    )
    _, state = init_state(cfg, 0)
    train_step = make_train_step(make_model(cfg), make_optimizer(cfg), cfg)
    batch = make_batch(batch_size, cfg.data, np.random.default_rng(0))
    key = jax.random.key(0)

    # Warmup / compile outside the trace.
    state, out = train_step(state, batch, key)
    float(out["loss"])

    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with jax.profiler.trace(TRACE_DIR):
        for _ in range(steps):
            state, out = train_step(state, batch, key)
        float(out["loss"])
    return steps


CATEGORIES = (
    ("fusion", re.compile(r"^(loop_)?fusion")),
    ("convolution/dot", re.compile(r"convolution|dot|cublas|matmul")),
    ("attention/custom-call", re.compile(r"attn|attention|custom-call")),
    ("copy/transpose", re.compile(r"copy|transpose|reshape|bitcast|concatenate|slice|pad|roll|dynamic")),
    ("reduce/norm", re.compile(r"reduce|norm")),
    ("all-reduce/collective", re.compile(r"all-|collective|psum")),
)


def parse_trace(steps: int):
    files = glob.glob(
        os.path.join(TRACE_DIR, "**", "*.trace.json.gz"), recursive=True
    )
    if not files:
        print("no trace files found under", TRACE_DIR)
        return
    with gzip.open(sorted(files)[-1], "rt") as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    # Device lanes: pid whose name names a device; fall back to all
    # complete events with 'dur'.
    pid_names = {
        e.get("pid"): e.get("args", {}).get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    device_pids = {
        p for p, n in pid_names.items() if re.search(r"/device:", n, re.I)
    }
    by_cat = collections.Counter()
    by_op = collections.Counter()
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if device_pids and e.get("pid") not in device_pids:
            continue
        name = e.get("name", "")
        dur = e["dur"]  # microseconds
        total += dur
        by_op[name] += dur
        for cat, pat in CATEGORIES:
            if pat.search(name):
                by_cat[cat] += dur
                break
        else:
            by_cat["other"] += dur
    print(f"total device time: {total/1e3:.1f} ms over {steps} steps "
          f"({total/1e3/steps:.1f} ms/step)")
    print("\nby category:")
    for cat, dur in by_cat.most_common():
        print(f"  {cat:<24} {dur/1e3:8.1f} ms  {100*dur/max(total,1):5.1f}%")
    print("\ntop 25 ops:")
    for name, dur in by_op.most_common(25):
        print(f"  {dur/1e3:8.1f} ms  {100*dur/max(total,1):5.1f}%  {name[:90]}")


if __name__ == "__main__":
    from edrl.device import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    parse_trace(run_profiled_steps())
