"""A/B timing of kernel K6 (``csrc/flashattn.cu``) between two sources.

    git show <parent>:src/repro_torch/csrc/flashattn.cu > build/flashattn_parent.cu
    python3 tools/ab_flashattn.py --parent build/flashattn_parent.cu

Builds the parent's source and this checkout's with ``nvcc`` (the flags of
``repro_torch.kernels._build``, both at once) into ``build/ab_flashattn/``
and binds both through ``ctypes``. The parent's C interface is the
self-attention one (``bh, s, hd``); the change's takes ``s_q, s_kv,
q_offset``, called here with S_q = S_kv and offset 0. At every shape, for
causal and not: whether the two outputs are bit-equal, then the two timed
in the order parent, change, change, parent, ``--pairs`` times over (each
time the mean of ``--calls`` launches between CUDA events). Then the
change's offset form (BH 72, 512 queries of 2048 keys, hd 64, causal) at
offsets 0 / 512 / 1024 / 1536 / 100 against ``flash_attention_plain``.
Prints one JSON line per record and a last line with the card's name and
power limit and each side's medians. Needs a CUDA card.
"""

import argparse
import ctypes
import json
import math
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flashattn as FA  # noqa: E402

#: (BH, S, hd, dtype): phase kernels' cases and the LM paths' prefill shapes
SHAPES = [(128, 2048, 64, torch.bfloat16), (16, 1000, 64, torch.float32),
          (28, 1024, 128, torch.bfloat16), (2, 4097, 128, torch.bfloat16),
          (72, 2048, 64, torch.float32), (160, 1500, 64, torch.bfloat16)]
OFFSETS = (0, 512, 1024, 1536, 100)
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def build(sources: dict, out: pathlib.Path) -> dict:
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen([_build._nvcc(), *_build.FLAGS, "-o",
                                     str(out / f"{name}.so"), str(src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines() if "registers" in line]
        print(json.dumps(dict(build=name, ptxas=regs)), flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    for fn in ("flash_attention_f32", "flash_attention_bf16"):
        getattr(libs["parent"], fn).argtypes = [P, P, P, P, I, I, I, I, F, P]
        getattr(libs["change"], fn).argtypes = [P, P, P, P, I, I, I, I, I, I, F, P]
    return libs


def launch(lib, name, q, k, v, causal, offset=0):
    out = torch.empty_like(q)
    fn = getattr(lib, "flash_attention_bf16" if q.dtype == torch.bfloat16
                 else "flash_attention_f32")
    bh, s, hd = q.shape
    args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s]
    if name == "change":
        args += [k.shape[1], offset]
    rc = fn(*args, hd, int(causal), 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream)
    if rc:
        sys.exit(f"{name} launch failed: cudaError {rc}")
    return out


def timed(fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / calls


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the parent's flashattn.cu")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--calls", type=int, default=50)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = build({"parent": pathlib.Path(args.parent).resolve(),
                  "change": _build.CSRC / "flashattn.cu"}, ROOT / "build" / "ab_flashattn")
    g = torch.Generator(device="cuda").manual_seed(0)
    summary = []
    for bh, s, hd, dt in SHAPES:
        q, k, v = (torch.randn((bh, s, hd), generator=g, device="cuda").to(dt) for _ in range(3))
        for causal in (False, True):
            a = launch(libs["parent"], "parent", q, k, v, causal)
            b = launch(libs["change"], "change", q, k, v, causal)
            ms = {"parent": [], "change": []}
            for side in ["parent", "change", "change", "parent"] * args.pairs:
                ms[side].append(timed(lambda: launch(libs[side], side, q, k, v, causal),
                                      args.calls))
            rec = dict(shape=[bh, s, hd], dtype=str(dt).split(".")[-1], causal=causal,
                       bit_equal=bool(torch.equal(a, b)), parent_ms=ms["parent"],
                       change_ms=ms["change"], parent_median=statistics.median(ms["parent"]),
                       change_median=statistics.median(ms["change"]))
            print(json.dumps(rec), flush=True)
            summary.append(rec)
    ok = all(r["bit_equal"] for r in summary)
    for dt in (torch.float32, torch.bfloat16):
        bh, s_kv, s_q, hd = 72, 2048, 512, 64
        q, k, v = (torch.randn((bh, s_kv, hd), generator=g, device="cuda").to(dt)
                   for _ in range(3))
        for off in OFFSETS:
            qq = q[:, off:off + s_q].contiguous()
            got = launch(libs["change"], "change", qq, k, v, True, off).float()
            ref = FA.flash_attention_plain(qq, k, v, True, off).float()
            print(json.dumps(dict(offset=off, dtype=str(dt).split(".")[-1],
                                  max_abs_err=float((got - ref).abs().max()),
                                  differ=float((got != ref).float().mean()))), flush=True)
    print(json.dumps(dict(card=card, all_bit_equal=ok, medians=[
        [r["shape"], r["dtype"], r["causal"], r["parent_median"], r["change_median"]]
        for r in summary])))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
