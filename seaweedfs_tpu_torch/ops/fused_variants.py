"""Design measurements for csrc/fused_reconstruct.cu, on the card.

    python3 -m seaweedfs_tpu_torch.ops.fused_variants [--old SRC]

Builds edited copies of the kernel's source beside the real one and times
each against it on the same inputs, kernel only, in turns (the list of
variants, then the same list reversed; each figure the mean of its two
turns), with CUDA events and a device-side spin before each start event
that hides the host's enqueue:

  * span2k, span1k: a block covers 2 KiB or 1 KiB instead of 4 KiB;
  * params32k: every launch carries the largest (32 KB) parameter block
    instead of the smallest that holds its work list;
  * k16: no k = 10 instantiation (16 survivors, predicated on k);
  * old (with --old SRC): an earlier fused_reconstruct.cu with the C
    interface of uniform calls reading their meta words from device
    memory, e.g. the file as of commit fa35e42
    (git show fa35e42:seaweedfs_tpu_torch/csrc/fused_reconstruct.cu).

Rows: the uniform calls of chip_smoke.py's phase 2b, flat and
block-diagonal, and bursts of 64 needle reads (one ragged call each; the
old kernel takes no ragged list).  Every variant's bytes are held equal
to the kernel's.  Also times a 30 KB pinned H2D, the alternative to
carrying the work list in the parameters.  Prints one JSON line per row.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import threading

import numpy as np
import torch

from . import _build, gf256, rs_cuda
from . import rs_resident as rr

SHAPES = [(1, 6144, 1), (64, 6144, 2), (256, 2048, 2), (16, 3 << 19, 2),
          (8, 2 << 20, 4)]
SURVIVOR_BYTES = 256 << 20
GROUPS = rs_cuda.BLOCKDIAG_GROUPS
# source edits of each variant: (text in csrc/fused_reconstruct.cu, edit)
VARIANTS = {
    "span2k": [("constexpr int kSpan = 4096;", "constexpr int kSpan = 2048;")],
    "span1k": [("constexpr int kSpan = 4096;", "constexpr int kSpan = 1024;")],
    "params32k": [("constexpr int kCapSmall = 64;", "constexpr int kCapSmall = 3816;"),
                  ("constexpr int kCapMid = 512;", "constexpr int kCapMid = 3816;")],
    "k16": [("  if (h.k == 10)\n", "  if (false)\n")],
}


def _build_variant(name: str, source: str) -> ctypes.CDLL:
    path = os.path.join(_build.BUILD_DIR, f"fused_{name}.cu")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(path, "w") as f:
        f.write(source)
    return ctypes.CDLL(_build._build(f"swfs_fused_{name}", _build._nvcc(),
                                     _build._NVCC_FLAGS, [path]))


def _build_all(old_src: str | None) -> dict:
    with open(os.path.join(_build._CSRC, "fused_reconstruct.cu")) as f:
        src = f.read()
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        for a, b in edits:
            if a not in text:
                raise RuntimeError(f"variant {name}: {a!r} not in the source")
            text = text.replace(a, b)
        sources[name] = text
    if old_src:
        with open(old_src) as f:
            sources["old"] = f.read()
    libs: dict = {"kernel": _build.kernels()}
    errors: list = []

    def one(name):
        try:
            libs[name] = _build_variant(name, sources[name])
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(n,)) for n in sources]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, lib in libs.items():
        fn = lib.fused_reconstruct_launch
        fn.restype = ctypes.c_int
        if name == "old":
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
        else:
            fn.argtypes = libs["kernel"].fused_reconstruct_launch.argtypes
    return libs


def _event_ms(fn, spin: int = 1_000_000) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


class Bench:
    def __init__(self, libs: dict, seed: int):
        self.libs = libs
        self.dev = torch.device("cuda")
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)
        self.surv = tuple(
            torch.randint(0, 256, (SURVIVOR_BYTES,), dtype=torch.uint8,
                          device=self.dev, generator=gen) for _ in range(10))
        self.ptrs = (ctypes.c_void_p * 10)(*[s.data_ptr() for s in self.surv])
        # the old kernel reads its meta words from device memory: each
        # list's words go up once, before any timing
        self.meta: dict = {}

    def system(self, layout: str, w: int):
        wanted = [0, 11, 5, 13][:w]
        mat, _ = gf256.reconstruction_matrix(
            10, 14, [i for i in range(14) if i not in wanted], wanted)
        if layout == "flat":
            return rs_cuda.prepare_matrix(mat, self.dev), 1
        return rr._prepared_blockdiag(mat.tobytes(), *mat.shape, GROUPS,
                                      "cuda"), GROUPS

    def run(self, name, a, g, w, tile, words, fetches):
        """One call of variant `name` -> its packed output."""
        out = torch.empty(int(np.sum(fetches)), dtype=torch.uint8,
                          device=self.dev)
        stream = torch.cuda.current_stream().cuda_stream
        if name == "old":  # uniform calls only: every fetch the same
            key = id(words)
            if key not in self.meta:
                self.meta[key] = (words, torch.from_numpy(
                    np.asarray(words, np.int32)).to(self.dev))
            meta = self.meta[key][1]
            rc = self.libs["old"].fused_reconstruct_launch(
                a.data_ptr(), a.shape[0] // 8, a.shape[1] // 8, self.ptrs, 10,
                meta.data_ptr(), len(words), int(fetches[0]), out.data_ptr(),
                w if g > 1 else 0, g, tile if g > 1 else int(fetches[0]),
                stream)
        else:
            masks = rr._bit_masks(a, 10, w, g, w)
            w32 = np.ascontiguousarray(words, dtype=np.int32)
            fk = np.ascontiguousarray(np.asarray(fetches) // 1024,
                                      dtype=np.int32)
            n, sent = ctypes.c_int(), ctypes.c_longlong()
            rc = self.libs[name].fused_reconstruct_launch(
                masks.ctypes.data, w, g, tile, self.ptrs, 10, w32.ctypes.data,
                fk.ctypes.data, len(w32), out.data_ptr(), stream,
                ctypes.byref(n), ctypes.byref(sent))
        if rc != 0:
            raise RuntimeError(f"{name}: launch failed ({rc})")
        return out

    def row(self, names, a, g, w, tile, lists) -> dict:
        """Each variant's median kernel time over `lists` (after two
        warm-up calls), in turns; its mismatched bytes on the first."""
        ref = self.run("kernel", a, g, w, tile, *lists[0])
        bad = {n: int((self.run(n, a, g, w, tile, *lists[0]) != ref).sum())
               for n in names}
        for x in lists:  # the old kernel's meta words go up here
            if "old" in names:
                self.run("old", a, g, w, tile, *x)
        turns: dict = {n: [] for n in names}
        for n in list(names) + list(reversed(names)):
            ts = [_event_ms(lambda: self.run(n, a, g, w, tile, *x))
                  for x in lists]
            turns[n].append(statistics.median(ts[2:]))
        return {"ms": {n: statistics.mean(t) for n, t in turns.items()},
                "turns": turns, "mismatched_bytes": bad}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", help="an earlier fused_reconstruct.cu to time")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fused_variants: no CUDA device")
    libs = _build_all(args.old)
    bench = Bench(libs, args.seed)
    rng = np.random.default_rng(args.seed)
    names = [n for n in ("old", "kernel", *VARIANTS) if n in libs]
    for layout in ("flat", "blockdiag"):
        for n, fetch, w in SHAPES:
            a, g = bench.system(layout, w)
            f, tile = ((fetch, rr._fused_tile_for(fetch)) if g == 1
                       else rr._blockdiag_fetch_tile(fetch, g))
            last = (SURVIVOR_BYTES - f) // rr.FUSED_ALIGN
            lists = []
            for _ in range(22):
                units = rng.integers(0, last + 1, n)
                words = (units << rr.META_ROW_BITS) | rng.integers(0, w, n)
                lists.append((words, [f] * n))
            print(json.dumps({"layout": layout, "shape": [n, fetch, w],
                              "fetch": f, **bench.row(names, a, g, w, tile,
                                                      lists)}), flush=True)
        # bursts: 64 reads of shards 0 and 11, 4 KB-1 MB log-uniform
        a, g = bench.system(layout, 2)
        lists = []
        for _ in range(14):
            reqs = [(int(s), int(o), int(z)) for s, o, z in zip(
                rng.choice([0, 11], 64),
                rng.integers(0, SURVIVOR_BYTES - (4 << 20), 64),
                np.exp(rng.uniform(np.log(4096), np.log(1 << 20), 64)))]
            calls = rr._ragged_calls(rr._plan(reqs), reqs, {0: 0, 11: 1}, g)
            lists.append((calls[0][1], calls[0][2]))
        print(json.dumps({"layout": layout, "shape": "burst",
                          "entries_median": statistics.median(
                              sum(-(-np.asarray(f) // rr.RAGGED_SPAN))
                              for _, f in lists),
                          **bench.row([x for x in names if x != "old"], a, g,
                                      2, g * rr.FUSED_ALIGN, lists)}),
              flush=True)
    src = torch.empty(30 << 10, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(30 << 10, dtype=torch.uint8, device=bench.dev)
    h2d = [_event_ms(lambda: dst.copy_(src, non_blocking=True))
           for _ in range(20)]
    floor = [_event_ms(lambda: torch.cuda._sleep(0)) for _ in range(20)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"h2d_30KB_ms": statistics.median(h2d),
                      "launch_floor_ms": statistics.median(floor),
                      "card": card}), flush=True)


if __name__ == "__main__":
    main()
