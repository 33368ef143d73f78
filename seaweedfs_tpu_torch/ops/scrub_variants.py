"""Design measurements for csrc/scrub.cu, on the card.

    python3 -m seaweedfs_tpu_torch.ops.scrub_variants [--lanes N] [--seed S]

Builds edited copies of the tensor-core scrub kernel's source beside the
real one and times each against it on the same resident-sized volume,
kernel only, in turns (the list of variants, then the same list reversed;
each figure the mean of its two turns' medians), with CUDA events and a
device-side spin before each start event that hides the host's enqueue:

  * stages2: a ring of 2 tiles instead of 3 (one tile in flight while
    one computes), two blocks an SM;
  * stages4: a ring of 4 tiles, which leaves room for one block an SM;
  * tile4k: 4 KiB tiles, 3 stages, one block an SM (its register limit
    lifted to 255);
  * cuda_cores: the earlier CUDA-core kernel (scrub_cuda_cores_launch).

The volume is RS(10,4), 14 shards of --lanes bytes (default: chip_smoke's
volume 1, 1,181,745,152 bytes a shard), data random from --seed, parity
from gf2_matmul, a few bytes flipped; rows: the flat and the 4-group
block-diagonal system.  Every variant's partials are held equal to the
kernel's.  Prints one JSON line per layout, with each variant's blocks an
SM and the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import threading

import torch

from . import _build, gf256, rs_cuda
from . import rs_resident as rr

LANES = 1_181_745_152
ITERS = 10
# source edits of each variant: (text in csrc/scrub.cu, edit)
VARIANTS = {
    "stages2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
                ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
    "tile4k": [("constexpr int kTile = 2048;", "constexpr int kTile = 4096;"),
               ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")],
}


def _build_all() -> dict:
    with open(os.path.join(_build._CSRC, "scrub.cu")) as f:
        src = f.read()
    libs: dict = {"kernel": _build.kernels()}
    errors: list = []

    def one(name, edits):
        try:
            text = src
            for a, b in edits:
                if a not in text:
                    raise RuntimeError(f"variant {name}: {a!r} not in the source")
                text = text.replace(a, b)
            path = os.path.join(_build.BUILD_DIR, f"scrub_{name}.cu")
            os.makedirs(_build.BUILD_DIR, exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
            libs[name] = ctypes.CDLL(_build._build(
                f"swfs_scrub_{name}", _build._nvcc(), _build._NVCC_FLAGS, [path]))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=item)
               for item in VARIANTS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    ref = libs["kernel"]
    for lib in libs.values():
        lib.scrub_launch.argtypes = ref.scrub_launch.argtypes
        lib.scrub_launch.restype = ctypes.c_int
        lib.scrub_blocks_per_sm.argtypes = ref.scrub_blocks_per_sm.argtypes
        lib.scrub_blocks_per_sm.restype = ctypes.c_int
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


def _volume(lanes: int, seed: int) -> tuple:
    """14 RS(10,4) shards of `lanes` bytes on the card, data from `seed`,
    parity by gf2_matmul, bytes flipped in shards 12 and 3."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    data = torch.randint(0, 256, (10, lanes), dtype=torch.uint8, device=dev,
                         generator=gen)
    a = rs_cuda.prepare_matrix(gf256.build_matrix(10, 14)[10:], dev)
    parity = rs_cuda.gf2_matmul(a, data, 4)
    parity[2, [0, lanes // 2, lanes - 1]] ^= 0x5A
    data[3, lanes // 3] ^= 0x5A
    torch.cuda.synchronize()
    return tuple(data[i] for i in range(10)) + tuple(parity[j] for j in range(4))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lanes", type=int, default=LANES)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scrub_variants: no CUDA device")
    libs = _build_all()
    vol = _volume(args.lanes, args.seed)
    ptrs = (ctypes.c_void_p * 14)(*[s.data_ptr() for s in vol])
    stream = torch.cuda.current_stream().cuda_stream
    names = [*libs, "cuda_cores"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for layout, groups in (("flat", 1), ("blockdiag", rs_cuda.BLOCKDIAG_GROUPS)):
        n_lanes = rr._scrub_span(args.lanes, groups * rr.LANE)
        if n_lanes > args.lanes:
            raise SystemExit(f"--lanes must be a multiple of {groups * rr.LANE}")
        a = rr._scrub_matrix(10, 14, groups, "cuda")
        masks = rr._scrub_masks(a, 10, 4, groups)
        n_seg = rr._scrub_segments(n_lanes, 28)

        def run(name):
            out = torch.empty((1, 4, n_seg), dtype=torch.int32, device="cuda")
            lib = libs["kernel" if name == "cuda_cores" else name]
            fn = (lib.scrub_cuda_cores_launch if name == "cuda_cores"
                  else lib.scrub_launch)
            rc = fn(masks.ctypes.data, 10, 4, groups, ptrs, 1, n_lanes, 28,
                    out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed ({rc})")
            return out

        ref = run("kernel")
        bad = {n: int((run(n) != ref).sum()) for n in names}
        turns: dict = {n: [] for n in names}
        for n in names + names[::-1]:
            ts = [_event_ms(lambda: run(n)) for _ in range(ITERS + 2)]
            turns[n].append(statistics.median(ts[2:]))
        ms = {n: statistics.mean(t) for n, t in turns.items()}
        bound_ms = (14 * n_lanes + 16 * n_seg) / 3.35e12 * 1e3
        print(json.dumps({
            "layout": layout, "n_lanes": n_lanes, "card": card,
            "partials": ref[0].tolist(), "mismatched_partials": bad,
            "ms": ms, "turns": turns, "bound_ms": bound_ms,
            "share_of_bound": {n: bound_ms / t for n, t in ms.items()},
            "blocks_per_sm": {n: libs[n].scrub_blocks_per_sm(10, 4, groups)
                              for n in libs},
        }), flush=True)


if __name__ == "__main__":
    main()
