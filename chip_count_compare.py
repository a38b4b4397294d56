"""Query (a) of ``chip_smoke.py`` timed on one card in two trees, in turns.

Two worker processes, one per tree, each generate the 100M-point bench cfg1
corpus of that tree's ``chip_smoke.py``, load it through that tree's store
and check (a)'s count against the numpy oracle. The driver then asks them in
turns A B, B A, A B, ... for blocks of ``--reps`` timed counts, so each
adjacent pair of blocks ran on the same card, seconds apart. Each block
times two things per rep, with a CUDA synchronise around each:

- ``count``: ``store.count("gdelt", Q_BOX)``, the (a) that chip_smoke times;
- ``program``: ``compiled.Program(plan, "count").run()`` read back with
  ``int``, the fused program alone, whose run the two trees share apart
  from counters: a control for the card's and the host's drift.

Prints each block's p50s, the median over blocks for each tree, and the
change-minus-parent difference of each adjacent pair; writes all of it to
``--out`` (``chiprun_out/count_compare.json``). Run from the change's root:

    python3 chip_count_compare.py PARENT_ROOT CHANGE_ROOT [--rounds 16]
        [--reps 40] [--n 100000000] [--out FILE] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def worker(root: str, n: int, device: str) -> None:
    # the protocol owns the real stdout; anything else printed goes to
    # stderr (a kernel build's report, nvcc's output)
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from geomesa_tpu_torch import DataStoreFinder
    from geomesa_tpu_torch.features.table import FeatureTable, StringColumn
    from geomesa_tpu_torch.index import compiled

    x, y, dtg, name, val = cs.corpus(n)
    lo = np.datetime64("2020-01-05", "ms").astype(np.int64)
    hi = np.datetime64("2020-01-12", "ms").astype(np.int64)
    want = int(np.count_nonzero((dtg > lo) & (dtg < hi) & (x >= -10)
                                & (x <= 30) & (y >= 30) & (y <= 55)
                                & (val > 10)))
    store = DataStoreFinder.get_data_store(type="torch", device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sft = store.create_schema("gdelt", cs.SPEC)
    store.load("gdelt", FeatureTable.build(sft, {
        "name": StringColumn(name, ["a", "b", "c"]), "val": val, "dtg": dtg,
        "geom": (x, y)}))
    del x, y, dtg, name, val
    planner = store.planner("gdelt")
    plan = planner.plan(cs.Q_BOX)
    got = store.count("gdelt", cs.Q_BOX)
    prog = int(compiled.Program(plan, "count").run()[0])
    if got != want or prog != want:
        raise AssertionError(f"{root}: (a) {got}, program {prog}, oracle "
                             f"{want}")
    stages = {"count": lambda: store.count("gdelt", cs.Q_BOX),
              "program": lambda: int(
                  compiled.Program(plan, "count").run()[0])}
    for fn in stages.values():
        for _ in range(20):
            fn()
    sync()
    print(json.dumps({"ready": root, "count": got}), file=proto, flush=True)
    for line in sys.stdin:
        reps = int(line)
        if reps <= 0:
            break
        out = {}
        for label, fn in stages.items():
            ts = []
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[label] = float(np.median(ts))
        print(json.dumps(out), file=proto, flush=True)


def _median(v):
    v = sorted(v)
    k = len(v) // 2
    return v[k] if len(v) % 2 else (v[k - 1] + v[k]) / 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--worker")
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--reps", type=int, default=40)
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--out", default="chiprun_out/count_compare.json")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a dry run of the protocol at a small --n")
    a = ap.parse_args()
    if a.worker:
        worker(a.worker, a.n, a.device)
        return 0
    if len(a.roots) != 2:
        ap.error("give PARENT_ROOT and CHANGE_ROOT")
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    print(card, flush=True)
    sides = ("parent", "change")
    procs = {}
    try:
        for side, root in zip(sides, a.roots):
            procs[side] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 os.path.abspath(root), "--n", str(a.n), "--device",
                 a.device],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        counts = {}
        for side, p in procs.items():
            line = p.stdout.readline()
            if not line:
                raise RuntimeError(f"{side} worker died before it was ready")
            counts[side] = json.loads(line)["count"]
        if counts["parent"] != counts["change"]:
            raise AssertionError(f"(a) counts differ: {counts}")
        blocks = {s: [] for s in sides}
        pairs = []
        for r in range(a.rounds):
            order = sides if r % 2 == 0 else sides[::-1]
            got = {}
            for side in order:
                p = procs[side]
                p.stdin.write(f"{a.reps}\n")
                p.stdin.flush()
                line = p.stdout.readline()
                if not line:
                    raise RuntimeError(f"{side} worker died in round {r}")
                got[side] = json.loads(line)
                blocks[side].append(got[side])
            pairs.append({k: got["change"][k] - got["parent"][k]
                          for k in got["change"]})
            print(json.dumps({"round": r, "order": list(order), **got}),
                  flush=True)
        summary = {
            "card": card, "n": a.n, "rounds": a.rounds, "reps": a.reps,
            "count": counts["change"],
            "median_of_block_p50_ms": {
                s: {k: _median([b[k] for b in blocks[s]])
                    for k in blocks[s][0]} for s in sides},
            "change_minus_parent_ms": {
                k: {"median": _median([d[k] for d in pairs]),
                    "change_slower_in": sum(d[k] > 0 for d in pairs),
                    "of_pairs": len(pairs)} for k in pairs[0]}}
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump({"summary": summary, "blocks": blocks,
                       "pairs": pairs}, fh, indent=1)
        print(json.dumps(summary), flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.stdin.write("0\n")
                    p.stdin.flush()
                    p.wait(timeout=60)
                except (OSError, subprocess.TimeoutExpired):
                    p.kill()
                    p.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
