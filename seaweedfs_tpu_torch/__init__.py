"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu for NVIDIA
Hopper (H100).

The JAX package seaweedfs_tpu is the reference and is left as it is; this
package imports nothing of it and nothing of JAX.  Layout mirrors it:

  ops/          GF(256) tables, the CPU oracle and codec, CRC32C, the GPU
                GF(2) matrix apply (rs_cuda, kernel csrc/gf2_matmul.cu), and
                the RSCodec front-end
  storage/      needle/volume formats, needle maps, the Volume write path
  storage/ec/   EC layout, staged bulk encode/rebuild/verify, decode, and
                EcVolume degraded reads
  storage/store.py, disk_location.py
                the volume server's registry of volumes and EC shards
  serving/      the continuous-batching EC read dispatcher and its QoS
  server/       the volume server's HTTP data plane (server/http.py: a
                small HTTP/1.1 server on asyncio streams)
  stats/, utils/
                a standard-library metrics registry; deadlines, tasks
  command/      `python3 -m seaweedfs_tpu_torch volume ...`

Entry points run on the card (backend "cuda") unless the caller names the
plain PyTorch version ("torch") or the numpy table oracle ("numpy"); with
no CUDA device, "cuda" raises.
"""

__version__ = "0.1.0"
