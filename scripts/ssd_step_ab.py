"""The SSD decode-step kernel from two sources, in turns, in one process on
one NVIDIA GPU; and the repository's kernel at several slice sizes.

Run from the repository root::

    python3 scripts/ssd_step_ab.py --baseline OTHER/csrc/ssd_step.cu [--candidate FILE.cu ...]

``--baseline`` is an earlier version of ``ssd_step.cu`` with the C interface
before the ``rows`` argument (for example the parent commit's, unpacked
with ``git show PARENT:src/repro_torch/kernels/ssd/csrc/ssd_step.cu`` into
a git-ignored directory).  Both sources are built with ``nvcc`` (sm_90a),
then, at the serve shapes (B 8 and 64, H 24, P 64, N 128, bf16 inputs from
a seed), in the order baseline, current, candidates (below), the
candidates again in reverse, current, baseline, each turn
checks the kernel against the plain version (y within 3 x the bf16
tolerance, state 1e-4) and times it with CUDA events in a CUDA graph,
states rotated past the 50 MB L2 as chip_smoke.py does: the baseline out of
place (the only call it has), the current kernel out of place and in place
(``out=state``, the decode step's call).  Each ``--candidate`` (a variant
of the current source with its C interface) is built too and takes turns
after the current kernel, timed as it is.  Then the current kernel in
place at 8, 16, 32 and 64 rows per CTA (``kernel.SLICE_BYTES``), each
beside an empty kernel on its grid (the launch floor).  Every timed call
writes a state of its own (no output buffer is reused), so each call
finds its state, read and written, cold in L2.

Prints one line per turn, the card's name and power limit, and last a JSON
object of all turns.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SHAPES = [(8, 24, 64, 128), (64, 24, 64, 128)]
ORDER = ("x", "dt", "a", "b", "c", "d", "state")
ROWS = (8, 16, 32, 64)


def bind_baseline(lib: ctypes.CDLL) -> None:
    """The C interface before the ``rows`` argument."""
    fn = lib.ssd_step_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", required=True, type=Path,
                    help="an earlier ssd_step.cu (launch without the rows argument)")
    ap.add_argument("--candidate", action="append", type=Path, default=[],
                    help="a variant of the current ssd_step.cu with its C interface")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ssd_step_ab: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.set_num_threads(1)
    from chip_smoke import COLD_BYTES, _cuda_ms, _ssd_bound, _ssd_inputs

    from repro_torch.kernels.nvcc import NvccLibrary
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ssd_decode_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = {"baseline": NvccLibrary(args.baseline.resolve(), "ssdstep_baseline", bind_baseline),
            "current": sk._LIB}
    for i, path in enumerate(args.candidate):
        libs[f"candidate {i} ({path.name})"] = NvccLibrary(path.resolve(), f"ssdstep_cand{i}",
                                                            sk._bind)
    with ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.load) for lib in libs.values()]:
            f.result()
    dev = torch.device("cuda")
    current = sk._LIB

    def baseline_call(t, st, y, out):
        b, h, p, n = st.shape
        err = libs["baseline"].lib.ssd_step_launch(
            *(t[k].data_ptr() for k in ORDER[:-1]), st.data_ptr(), y.data_ptr(),
            out.data_ptr(), b, h, p, n, 1, 1, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"baseline launch failed: cudaError {err}")

    turns = []
    for b, h, p, n in SHAPES:
        t = _ssd_inputs(torch, b, b, h, p, n, torch.bfloat16, dev)
        others = [t[k] for k in ORDER[:-1]]
        y_ref, s_ref = ssd_decode_step(*others, t["state"], impl="ref")
        k = max(2, int(np.ceil(COLD_BYTES / (b * h * p * n * 4))))
        states = [t["state"].clone() for _ in range(k)]
        outs = [torch.empty_like(t["state"]) for _ in range(k)]
        y = torch.empty_like(t["x"])
        reps = max(4, 640 // k)
        bound_ms = _ssd_bound(b, h, p, n, 2)[0]

        def ok(y_got, s_got):
            tol = 3 * 3e-2
            return bool(torch.allclose(y_got.float(), y_ref.float(), atol=tol, rtol=tol)
                        and torch.allclose(s_got, s_ref, atol=1e-4, rtol=1e-4))

        cands = [name for name in libs if name.startswith("candidate")]
        for name in ["baseline", "current", *cands, *cands[::-1], "current", "baseline"]:
            if name == "baseline":
                out = torch.empty_like(t["state"])
                baseline_call(t, t["state"], y, out)
                good = ok(y, out)
                runs = {"out of place": lambda: [baseline_call(t, st, y, o)
                                                 for st, o in zip(states, outs)]}
            else:
                sk._LIB = libs[name]
                st = t["state"].clone()
                y_in, s_in = ssd_decode_step(*others, st, out=st)
                y_oop, s_oop = ssd_decode_step(*others, t["state"])
                good = ok(y_in, s_in) and torch.equal(s_in, s_oop) and torch.equal(y_in, y_oop)
                runs = {"out of place": lambda: [ssd_decode_step(*others, st)
                                                 for st in states],
                        "in place": lambda: [ssd_decode_step(*others, st, out=st)
                                             for st in states]}
            torch.cuda.synchronize()
            if not good:
                raise RuntimeError(f"the {name} kernel disagrees with the plain version at "
                                   f"B {b}")
            ms = {call: _cuda_ms(torch, run, True, reps) / k for call, run in runs.items()}
            turn = {"build": name, "shape": [b, h, p, n], "ms": ms,
                    "share_of_bound": {c: bound_ms / v for c, v in ms.items()}}
            turns.append(turn)
            print(f"B {b}: {name}: agrees with the plain version; device ms per call in a CUDA "
                  f"graph {ms}; share of the {bound_ms:.8f} ms bound "
                  f"{ {c: round(v, 4) for c, v in turn['share_of_bound'].items()} }", flush=True)

        sk._LIB = current
        slice_bytes = sk.SLICE_BYTES
        for rows in ROWS:
            sk.SLICE_BYTES = rows * n * 4
            assert sk.rows_per_cta(n, p) == rows
            st = t["state"].clone()
            y_in, s_in = ssd_decode_step(*others, st, out=st)
            torch.cuda.synchronize()
            if not ok(y_in, s_in):
                raise RuntimeError(f"the kernel at {rows} rows per CTA disagrees at B {b}")
            ms = _cuda_ms(torch, lambda: [ssd_decode_step(*others, s, out=s) for s in states],
                          True, reps) / k
            floor = _cuda_ms(torch, lambda: [sk.empty_launch(b, h, p, n, dev) for _ in states],
                             True, reps) / k
            turn = {"build": "current", "shape": [b, h, p, n], "rows_per_cta": rows,
                    "ctas": b * h * -(-p // rows), "ms": {"in place": ms}, "floor_ms": floor,
                    "share_of_bound": {"in place": bound_ms / ms}}
            turns.append(turn)
            print(f"B {b}: current, {rows} rows per CTA ({turn['ctas']} CTAs): in place "
                  f"{ms:.6f} ms ({bound_ms / ms:.4f} of the bound), launch floor {floor:.6f} "
                  f"ms", flush=True)
        sk.SLICE_BYTES = slice_bytes
        del states, outs
    print(smi)
    print(json.dumps({"card": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
