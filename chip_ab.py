"""One leg of a comparison of two checkouts of the port on one card: 5c
(`chip_smoke.phase_serve`) on a 3 GiB volume, then phase 8
(`chip_smoke.phase_ingest`) INGEST_REPS times, each with the phase functions
of the checkout named.  JSON lines (chip_smoke's own, plus one per ingest
run) on stdout.

    python3 chip_ab.py <checkout> <label> [ingest]

(`ingest`: phase 8 alone, INGEST_REPS times.)

Run the legs in one call on one card, parent and change alternating
(parent, change, change, parent), each in its own process; a checkout of
the parent commit comes from `git archive` into a git-ignored directory."""
import json
import os
import shutil
import sys
import time
import traceback

INGEST_REPS = 3


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    label = sys.argv[2]
    ingest_only = sys.argv[3:] == ["ingest"]
    # this checkout's chip_smoke and package, in the client processes
    # that 5c spawns too (they inherit sys.path)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from seaweedfs_tpu_torch.ops import rs_cuda

    work = os.path.join(root, "ab_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    try:
        cs.phase_device(torch)
        if not ingest_only:
            vol = cs.phase_volume(work, 0, 3 << 30)
            k1 = (rs_cuda.gf2_matmul, rs_cuda.gf2_matmul_small)
            enc = cs.phase_encode(torch, work, vol["dat_size"], k1, 0)
            deg = cs.phase_degraded(work, vol, enc["shard_size"], k1, 0)
            cs.phase_serve(torch, work, vol, deg, 0)
        for i in range(INGEST_REPS):
            d = os.path.join(work, f"ingest{i}")
            os.makedirs(d)
            try:
                cs.phase_ingest(torch, d, 0)
                print(json.dumps({"ab": label, "ingest_rep": i, "ok": True}),
                      flush=True)
            except Exception as e:  # noqa: BLE001 — counted, not fatal
                traceback.print_exc()
                print(json.dumps({"ab": label, "ingest_rep": i, "ok": False,
                                  "error": repr(e)[:300]}), flush=True)
            shutil.rmtree(d, ignore_errors=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ab": label, "wall_s": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
