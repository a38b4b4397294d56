"""The geometry catalog's pair kernels under every launch plan, on one card.

    python3 chip_geom_plans.py [--out FILE] [--quick]

``geom_dist`` and ``geom_pred`` (op 0, intersects) run over ``chip_smoke.py``'s
(m3) layer (500,000 closed quadrilaterals: K 8, S 4; and its first 50,000,
5,328 and 45, the batch sizes of (q3) and (q4)) and (m1) layer (5,000,000
single-segment lines: K 2, S 1), packed on the card, against POINT(1 39)
(L 1, P 1), M_WKT (L 4, P 8) and star-shaped rings of 7 to 1,023 edges
around (1, 39) (L and P 8 to 1,024 after the literal's padding), under
each plan ``kernels/geom.py`` can launch: lanes over the feature's items
with 1 to 32 lanes a feature (ITEMS), and a warp a feature with its lanes
over the literal (LIT). Every plan's output must equal the plan ``plan``
picks, bit for bit. An answer is ``chip_smoke.cuda_ms`` over back-to-back
calls; the table says which plan is fastest at each shape, which is what
``plan`` encodes. ``--quick`` keeps the 500,000 quads only.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PLANS = [(False, 1), (False, 2), (False, 4), (False, 8), (False, 16),
         (False, 32), (True, 32)]
RING_EDGES = (7, 15, 31, 63, 127, 255, 1023)
SMALL = ("POINT(1 39)", "M_WKT", "ring 31", "ring 63", "ring 127",
         "ring 255", "ring 1023")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "_plans_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep(cs, geom, args, lname, n, lits, natural) -> list:
    """Every plan of both kernels on one pack against its literals."""
    import torch
    K, S = int(args[0].shape[1]), int(args[2].shape[1])
    names = list(lits)
    if n != (cs.M_N if lname == "lines" else cs.M_POLY_N):
        names = SMALL
    elif lname == "lines":
        names = [k for k in names if int(lits[k][0].shape[0]) <= 256]
    rows = []
    for litname in names:
        ls, lp, lpoly = lits[litname]
        L, P = int(ls.shape[0]), int(lp.shape[0])
        calls = {
            "geom_dist": lambda: geom.geom_dist(*args, ls, lp, lpoly),
            "geom_pred": lambda: geom.geom_pred(*args, ls, lp, 0, lpoly,
                                                True)}
        for kname, call in calls.items():
            want = call()
            torch.cuda.synchronize()
            want = want if isinstance(want, tuple) else (want,)
            times = {}
            for plan in PLANS:
                geom.plan = lambda *_, plan=plan: plan
                try:
                    got = call()
                    torch.cuda.synchronize()
                    got = got if isinstance(got, tuple) else (got,)
                    if any(not torch.equal(x, y) for x, y in zip(got, want)):
                        raise AssertionError(
                            f"{kname} {lname} x {litname} plan {plan} "
                            "differs from the natural plan's output")
                    once = cs.cuda_ms(call, 1)
                    reps = max(3, min(50, int(200.0 / max(once, 1e-3))))
                    times[f"{'LIT' if plan[0] else 'ITEMS'} G{plan[1]}"] = \
                        cs.cuda_ms(call, reps)
                finally:
                    geom.plan = natural
            pick = natural(n, K, S, L, P)
            row = {"kernel": kname, "layer": lname,
                   "rows": n, "K": K, "S": S, "literal": litname, "L": L,
                   "P": P, "ms": times, "fastest": min(times, key=times.get),
                   "picked": f"{'LIT' if pick[0] else 'ITEMS'} G{pick[1]}"}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false")
    cs = _smoke()
    from geomesa_tpu_torch.features.geometry import (POINT, POLYGON,
                                                     GeometryArray, parse_wkt)
    from geomesa_tpu_torch.geom import catalog
    from geomesa_tpu_torch.kernels import geom
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    rings = cs.quads(cs.M_POLY_N, cs.M_SEED + 2)
    lv = np.arange(cs.M_POLY_N + 1, dtype=np.int64)
    layers = {"quads": GeometryArray(
        np.full(cs.M_POLY_N, POLYGON, dtype=np.int8), lv, lv, 5 * lv,
        rings.reshape(-1, 2))}
    if not a.quick:
        ax, ay, bx, by = cs.cfg2_segments(cs.M_N, cs.M_SEED)
        coords = np.empty((2 * cs.M_N, 2))
        coords[0::2, 0], coords[0::2, 1] = ax, ay
        coords[1::2, 0], coords[1::2, 1] = bx, by
        layers["lines"] = GeometryArray.linestrings(coords)
    literals = {"POINT(1 39)": (POINT, [1.0, 39.0]),
                "M_WKT": parse_wkt(cs.M_WKT)}
    literals.update({f"ring {n}": cs.star_ring(n) for n in RING_EDGES})
    natural = geom.plan
    packs = {}
    for lname, arr in layers.items():
        sizes = (len(arr),) if lname == "lines" or a.quick else (
            len(arr), 50_000, 5_328, 45)
        full = catalog.pack_features(arr, np.arange(len(arr)), dev)
        for n in sizes:
            packs[(lname, n)] = tuple(t[:n] for t in full.rows(
                *catalog.PAIR))
    lits = {k: catalog.pack_literal(v, dev) for k, v in literals.items()}
    rows = []
    t_start = time.perf_counter()
    for (lname, n), args in packs.items():
        rows += sweep(cs, geom, args, lname, n, lits, natural)
    print(f"[done] {len(rows)} shapes in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump({"card": card, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
