"""The polygon refine on one card: a parent tree against this one.

    python3 chip_pip_compare.py PARENT_DIR [--out DIR] [--turns N]

PARENT_DIR is an unpacked tree (``git archive``) of a commit whose port
refines with the one-thread-per-point kernel ``csrc/pip_band.cu`` (C entry
``pip_band_launch``) and carries its own ``chip_smoke.py``. In one process
on one card, this script:

1. builds the parent's kernel with this tree's nvcc flags and prints the
   SASS instructions per (point, edge) pair of both kernels' inner loops
   (``chip_smoke.sass_per_pair``);
2. runs each tree's ``chip_smoke.py`` in turns (parent, change, change,
   parent, ...) and reads from each run the query p50s, the profile of
   queries (a)-(c) and the kernel's time at main path (b)'s inputs; every
   run must end with its ``{"ok": true, ...}`` line;
3. times the refine's device work at the near-edge shapes of
   ``chip_smoke.py``, unmasked and under 20% masks, in turns: the parent's
   (its kernel over every row and the padded table, then ``m & cin`` and
   ``m & ~cin & ~cout``) against this tree's ``pip_refine``; the two must
   give byte-equal hit and unc.

The runs' full output goes under ``--out``; the last line of standard
output is one JSON summary. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import chip_smoke as smoke

HERE = os.path.dirname(os.path.abspath(__file__))


def build_parent(parent: str) -> str:
    """nvcc the parent's pip_band.cu into its own _build directory."""
    from geomesa_tpu_torch.kernels import build
    src = os.path.join(parent, "geomesa_tpu_torch", "kernels", "csrc",
                       "pip_band.cu")
    out = os.path.join(parent, "geomesa_tpu_torch", "_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libpip_band-parent.so")
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the parent kernel:\n{r.stdout}"
                           f"{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            smoke.log(f"[parent build] {line.strip()}")
    return so


def parent_refine_fn(so: str):
    """The parent's refine on the card: its kernel's flags over every row
    (the padded table), then the three mask operations of its Program.run."""
    import torch
    from geomesa_tpu_torch.index import scan
    lib = ctypes.CDLL(so)
    fn = lib.pip_band_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_float, p, p, p]
    fn.restype = ctypes.c_int

    def refine(px, py, edges, mask):
        n = px.shape[0]
        cin = torch.empty(n, dtype=torch.bool, device=px.device)
        cout = torch.empty(n, dtype=torch.bool, device=px.device)
        rc = fn(px.data_ptr(), py.data_ptr(), edges.data_ptr(), n,
                edges.shape[0], scan.TOL_T, scan.TOL_D, scan.DY_BAND,
                cin.data_ptr(), cout.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent pip_band launch failed ({rc})")
        if mask is None:
            return cin, ~cin & ~cout
        return mask & cin, mask & ~cin & ~cout

    return refine


def run_smoke(tree: str, label: str, out_dir: str) -> dict:
    """One chip_smoke.py run of a tree; what it measured, from its lines."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                       capture_output=True, text=True, timeout=1500)
    secs = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"smoke_{label}.log"), "w") as fh:
        fh.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    lines = r.stdout.splitlines()
    if r.returncode != 0 or not lines or not lines[-1].startswith('{"ok": true'):
        raise RuntimeError(f"chip_smoke.py of {label} failed "
                           f"(rc {r.returncode}):\n{r.stderr[-3000:]}")
    got = {"seconds": secs, "profile": {}}
    for line in lines:
        if line.startswith('{"main_path"'):
            got["p50_ms"] = json.loads(line)["main_path"]["p50_ms"]
        elif line.startswith('{"profile"'):
            prof = json.loads(line)["profile"]
            got["profile"][prof["query"]] = {
                k: prof.get(k) for k in (
                    "device_busy_ms", "device_activities", "wall_ms_profiled",
                    "index_select", "index_select_float", "top")}
        elif line.startswith('{"kernels"'):
            k = json.loads(line)["kernels"][0]
            got["kernel_main_b_ms"] = k["ms"]
            got["kernel_main_b_bound_ms"] = k["bound_ms"]
        elif "[build]" in line and "SASS" in line:
            got["sass"] = line
    smoke.log(f"[smoke {label}] {secs:.1f} s: p50 {got.get('p50_ms')}, "
              f"kernel at main (b) {got.get('kernel_main_b_ms')} ms, (b) busy "
              f"{got['profile'].get('b_poly_count', {}).get('device_busy_ms')} ms")
    return got


def near_edge_turns(parent_refine, turns: int) -> dict:
    """Parent and change at the near-edge shapes, in turns, byte-equal."""
    import torch
    from geomesa_tpu_torch.kernels import pip

    dev = torch.device("cuda")
    out = {}
    for label, ring, seed in (("concave8", smoke.CONCAVE, 11),
                              ("ring1024", smoke.ring_1000(), 12)):
        px, py = smoke.near_edge_points(ring, smoke.KERNEL_N, seed)
        t = [torch.from_numpy(a).to(dev)
             for a in (px, py, smoke.padded_edges(ring))]
        ne = len(ring) - 1
        masks = {"unmasked": None, **{
            k: torch.from_numpy(v).to(dev)
            for k, v in smoke.near_edge_masks(smoke.KERNEL_N, seed).items()}}
        reps = 20 if label == "concave8" else 5
        for mlabel, m in masks.items():
            def change():
                return pip.pip_refine(*t, mask=m, n_edges=ne)

            def parent():
                return parent_refine(*t, m)

            a, b = change(), parent()
            torch.cuda.synchronize()
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{label} {mlabel}: parent and change "
                                     f"differ")
            times = {"parent": [], "change": []}
            for turn in range(turns):
                order = ("parent", "change") if turn % 2 == 0 \
                    else ("change", "parent")
                for who in order:
                    fn = parent if who == "parent" else change
                    times[who].append(smoke.cuda_ms(fn, reps))
            key = f"{label}_{mlabel}"
            out[key] = times
            smoke.log(f"[near-edge] {key}: parent {times['parent']} ms, "
                      f"change {times['change']} ms")
        del t, masks
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("--out", default=os.path.join(HERE, "pip_compare_out"))
    ap.add_argument("--turns", type=int, default=4,
                    help="chip_smoke.py runs and near-edge timings per "
                         "shape, alternating parent and change")
    args = ap.parse_args()
    parent = os.path.abspath(args.parent)
    os.makedirs(args.out, exist_ok=True)

    smi, _ = smoke.phase_device()
    smoke.log(f"[device] nvidia-smi: {smi}")
    from geomesa_tpu_torch.kernels import build, pip
    build.build([pip.NAME])
    so = build_parent(parent)
    sass = {"parent": smoke.sass_per_pair(so),
            "change": smoke.sass_per_pair(build._target(pip.NAME)[1])}
    smoke.log(f"[sass] {json.dumps(sass)}")

    runs = []
    for turn in range(args.turns):
        who = ("parent", "change", "change", "parent")[turn % 4]
        runs.append({"tree": who, **run_smoke(
            parent if who == "parent" else HERE, f"{who}{turn}", args.out)})

    near = near_edge_turns(parent_refine_fn(so), args.turns)
    summary = {"device": smi, "sass": sass, "smoke_runs": runs,
               "near_edge_ms": near}
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
