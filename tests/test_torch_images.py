"""On-read image crop and resize, and the upload-time EXIF orientation fix
(C8), held against the JAX package's volume server.

The same PNG, JPEG and text needles are written to the port's and the
reference's servers (each over its own directory, no master), then read
with each query the reference's read path knows (width/height, each mode,
crop_x1..y2, crop with resize, a non-integer parameter, a non-image mime):
statuses, bodies and the variant Etags must be equal.  A JPEG carrying an
EXIF orientation tag, uploaded under -images.fix.orientation, is stored as
the same upright bytes by both.
"""
import asyncio
import io

import pytest

from seaweedfs_tpu_torch.images.orientation import ORIENTATION_TAG
from seaweedfs_tpu_torch.operation.upload import multipart_body
from seaweedfs_tpu_torch.server import volume as server_volume
from seaweedfs_tpu_torch.server.http import Client

Image = pytest.importorskip("PIL.Image")

PNG_FID = "/3,01637037d6"
JPEG_FID = "/3,02637037d6"
TEXT_FID = "/3,03637037d6"
ROTATED_FID = "/3,04637037d6"


def _png() -> bytes:
    img = Image.new("RGB", (100, 60), (0, 0, 255))
    for x in range(30):
        for y in range(20):
            img.putpixel((x, y), (200, 10, 10))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _jpeg(orientation: int = 1) -> bytes:
    img = Image.new("RGB", (80, 40), (255, 0, 0))
    for x in range(40, 80):
        for y in range(40):
            img.putpixel((x, y), (0, 0, 255))
    buf = io.BytesIO()
    if orientation != 1:
        exif = Image.Exif()
        exif[ORIENTATION_TAG] = orientation
        img.save(buf, format="JPEG", exif=exif, quality=95)
    else:
        img.save(buf, format="JPEG", quality=95)
    return buf.getvalue()


NEEDLES = {
    PNG_FID: ("p.png", "image/png", _png()),
    JPEG_FID: ("j.jpg", "image/jpeg", _jpeg()),
    TEXT_FID: ("t.txt", "text/plain", b"not an image, " * 40),
}

QUERIES = [
    "width=50", "height=30", "width=40&height=40",
    "width=40&height=40&mode=fit", "width=40&height=40&mode=fill",
    "width=7&height=90&mode=fill", "crop_x1=10&crop_y1=5&crop_x2=60&crop_y2=35",
    "crop_x1=10&crop_y1=5&crop_x2=500&crop_y2=500",
    "crop_x1=50&crop_y1=5&crop_x2=10&crop_y2=35",
    "crop_x1=0&crop_y1=0&crop_x2=40&crop_y2=30&width=20",
    "width=abc", "crop_x1=1.5&crop_x2=9", "mode=fit", "width=0&height=0",
]


async def _both(tmp_path, **kw):
    from seaweedfs_tpu.server.volume import VolumeServer as RefVolumeServer

    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port_dir.mkdir()
    ref_dir.mkdir()
    port = server_volume.VolumeServer([], [str(port_dir)], port=0,
                                      ec_backend="numpy", **kw)
    ref = RefVolumeServer(masters=[], directories=[str(ref_dir)], port=0,
                          grpc_port=0, ec_backend="numpy", **kw)
    for vs in (port, ref):
        vs.store.add_volume(3)
    await port.start()
    await ref.start(heartbeat=False)
    return port, ref


async def _ask(vs, method, path, headers=None, body=b""):
    c = Client("127.0.0.1", vs.port)
    try:
        return await c.request(method, path, headers, body)
    finally:
        await c.close()


async def _put(vs, fid, name, mime, data):
    body, ctype = multipart_body(data, name, mime, False)
    status, _, resp = await _ask(vs, "POST", fid, {"Content-Type": ctype},
                                 body)
    assert status == 201 or status == 200, resp


def test_image_reads_match_the_reference(tmp_path):
    async def go():
        port, ref = await _both(tmp_path)
        try:
            for fid, (name, mime, data) in NEEDLES.items():
                for vs in (port, ref):
                    await _put(vs, fid, name, mime, data)
            transformed = 0
            for fid, (_, _, data) in NEEDLES.items():
                for q in QUERIES:
                    (ps, ph, pb), (rs, rh, rb) = [
                        await _ask(vs, "GET", f"{fid}?{q}")
                        for vs in (port, ref)]
                    assert (ps, pb) == (rs, rb), (fid, q, ps, rs)
                    if ps == 200:
                        transformed += pb != data
                        assert ph.get("Etag") == rh.get("Etag"), (fid, q)
                        assert ph.get("Content-Type") == rh.get(
                            "Content-Type"), (fid, q)
                    heads = [await _ask(vs, "HEAD", f"{fid}?{q}")
                             for vs in (port, ref)]
                    assert [h[0] for h in heads] == [ps, ps], (fid, q)
                    if ps == 200:
                        assert heads[0][1].get("Content-Length") == \
                            heads[1][1].get("Content-Length") == str(len(pb))
            # the cases above really transformed images (not only passed
            # the original bytes through on both sides)
            assert transformed == 18
            # a resize's size: 100x60 at width=50 is 50x30
            _, _, body = await _ask(port, "GET", f"{PNG_FID}?width=50")
            assert Image.open(io.BytesIO(body)).size == (50, 30)
            # a non-integer parameter is a 400 with the reference's text
            st, _, body = await _ask(port, "GET", f"{JPEG_FID}?height=x")
            assert (st, body) == (400, b"width/height/crop_* must be integers")
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(go())


def test_orientation_fix_on_upload_matches_the_reference(tmp_path):
    rotated = _jpeg(orientation=6)

    async def go():
        port, ref = await _both(tmp_path, fix_jpg_orientation=True)
        try:
            assert port.fix_jpg_orientation
            for vs in (port, ref):
                await _put(vs, ROTATED_FID, "r.jpg", "image/jpeg", rotated)
                # a JPEG named .jpg without the image mime is fixed too
                await _put(vs, JPEG_FID, "n.jpeg", "", rotated)
            for fid in (ROTATED_FID, JPEG_FID):
                for q in ("", "?width=10"):
                    got = [await _ask(vs, "GET", fid + q)
                           for vs in (port, ref)]
                    assert [g[0] for g in got] == [200, 200]
                    assert got[0][2] == got[1][2], (fid, q)
            _, _, body = await _ask(port, "GET", ROTATED_FID)
            assert body != rotated
            img = Image.open(io.BytesIO(body))
            assert img.size == (40, 80)  # turned upright: 80x40 -> 40x80
            assert img.getexif().get(ORIENTATION_TAG, 1) == 1
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(go())


def test_orientation_left_alone_without_the_flag(tmp_path):
    rotated = _jpeg(orientation=6)

    async def go():
        port, ref = await _both(tmp_path)
        try:
            for vs in (port, ref):
                await _put(vs, ROTATED_FID, "r.jpg", "image/jpeg", rotated)
            got = [await _ask(vs, "GET", ROTATED_FID) for vs in (port, ref)]
            assert got[0][2] == got[1][2] == rotated
        finally:
            await port.stop()
            await ref.stop()

    asyncio.run(go())
