"""The port's decode service and `decode --ppm/--y4m` on the CPU, against
the JAX package's service (`backend="numpy"`) and CLI.

Both servers run in-process on ephemeral ports, as tests/test_serve.py
runs the JAX one. The ViT tolerance is tests/test_torch_vit.py's.
"""

import socket
import struct
import threading

import jax
import numpy as np
import pytest
import torch

from hvqm4_tpu import cli as jcli
from hvqm4_tpu import serve as jserve
from hvqm4_tpu.models import vit as jvit
from hvqm4_tpu_torch import cli, serve
from hvqm4_tpu_torch.config import SeqConfig
from hvqm4_tpu_torch.convert import vit_params_to_torch
from hvqm4_tpu_torch.models.vit import ViT, ViTConfig
from tools.encoder import make_clip

torch.set_num_threads(1)

VIT_ARGS = (32, 8, 64, 2, 4)
MODES = (serve.MODE_YUV, serve.MODE_RGB, serve.MODE_EMBED)


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def servers():
    """(port's server on cpu, JAX numpy server), both with the ViT set from
    the same JAX weights."""
    jcfg = jvit.ViTConfig(*VIT_ARGS)
    params = jvit.init_vit(jcfg, jax.random.key(0))
    model = ViT(ViTConfig(*VIT_ARGS))
    model.load_state_dict(vit_params_to_torch(
        jax.tree_util.tree_map(np.asarray, params), "cpu"))
    port = _start(serve.DecodeServer(("127.0.0.1", 0), device="cpu"))
    port._vit = (ViTConfig(*VIT_ARGS), model)
    ref = _start(jserve.DecodeServer(("127.0.0.1", 0), backend="numpy"))
    ref._vit = (jcfg, params)
    yield port, ref
    _stop(port)
    _stop(ref)


def _embeddings_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.frombuffer(a, "<f4"), np.frombuffer(b, "<f4")
        assert a.shape == b.shape == (VIT_ARGS[2],)
        assert np.abs(a - b).max() <= 2e-2
        assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= 0.9999


@pytest.mark.parametrize("w,h,samp,gops,seed", [
    (64, 48, 2, ["IPBPB", "IP"], 1),
    (48, 64, 1, ["IPB"], 2),   # portrait, 4:4:4
])
def test_replies_match_jax_server(servers, w, h, samp, gops, seed):
    port, ref = servers
    clip = make_clip(SeqConfig(w, h, samp, samp), gops, seed=seed)
    got, want = ([serve.decode_remote(*s.server_address, clip, mode=m)
                  for m in MODES] for s in (port, ref))
    assert got[0] == want[0]  # YUV, byte for byte
    assert got[1] == want[1]  # RGB, byte for byte
    _embeddings_close(got[2], want[2])


def test_mux_out_of_order_and_errors(servers):
    """Pipelined requests of mixed modes over one connection, read in
    reverse; each equals its single-shot reply, and a garbage clip fails
    only its own request."""
    port, _ = servers
    host, p = port.server_address
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPB"], seed=40 + i) for i in range(3)]
    jobs = list(zip(clips, MODES))
    want = [serve.decode_remote(host, p, c, mode=m) for c, m in jobs]
    with serve.MuxClient(host, p) as mc:
        ids = [mc.submit(c, m) for c, m in jobs]
        bad = mc.submit(b"not a container", serve.MODE_RGB)
        for i in reversed(range(len(jobs))):
            assert mc.result(ids[i], timeout=120) == want[i]
        with pytest.raises(RuntimeError, match="server error"):
            mc.result(bad, timeout=120)
        assert mc.decode(clips[0], serve.MODE_YUV, timeout=120) == want[0]


def test_metrics_count_by_mode():
    srv = _start(serve.DecodeServer(("127.0.0.1", 0), device="cpu",
                                    vit_cfg=ViTConfig(*VIT_ARGS)))
    try:
        host, p = srv.server_address
        clip = make_clip(SeqConfig(32, 16), ["IP"], seed=9)
        for m in (serve.MODE_YUV, serve.MODE_YUV, serve.MODE_RGB,
                  serve.MODE_EMBED):
            serve.decode_remote(host, p, clip, mode=m)
        m = serve.fetch_metrics(host, p)
        assert m["by_mode"] == {"yuv": 2, "rgb": 1, "embed": 1}
        assert m["requests_total"] == 4 and m["frames_served"] == 8
        assert m["errors"] == 0 and m["batches"] == 0  # no batching
        # the lazily built ViT is the port's, on the server's device
        vcfg, model = srv._vit
        assert vcfg == ViTConfig(*VIT_ARGS) and isinstance(model, ViT)
        assert model.patch_w.device.type == "cpu"
    finally:
        _stop(srv)


def test_auth():
    srv = _start(serve.DecodeServer(("127.0.0.1", 0), device="cpu",
                                    auth_token="sekrit"))
    try:
        host, p = srv.server_address
        clip = make_clip(SeqConfig(32, 16), ["I"], seed=10)
        with pytest.raises(PermissionError):
            serve.decode_remote(host, p, clip)
        with pytest.raises(PermissionError):
            serve.decode_remote(host, p, clip, token="wrong")
        assert len(serve.decode_remote(host, p, clip, token="sekrit")) == 1
        assert serve.fetch_metrics(host, p, token="sekrit")[
            "auth_failures"] == 2
    finally:
        _stop(srv)


def test_pixel_cap_and_session_lru():
    srv = _start(serve.DecodeServer(("127.0.0.1", 0), device="cpu",
                                    max_pixels=64 * 48, max_sessions=2))
    try:
        host, p = srv.server_address
        with pytest.raises(RuntimeError, match="pixel cap"):
            serve.decode_remote(host, p, make_clip(SeqConfig(128, 96), ["I"],
                                                   seed=11))
        for w, h in [(32, 32), (64, 48), (32, 48)]:
            assert serve.decode_remote(host, p, make_clip(
                SeqConfig(w, h), ["I"], seed=12))
            assert len(srv._sessions) <= 2
        assert list(srv._sessions) == [SeqConfig(64, 48), SeqConfig(32, 48)]
    finally:
        _stop(srv)


def test_oversized_clip_gets_an_error_reply(servers):
    host, p = servers[0].server_address
    with socket.create_connection((host, p), timeout=30) as s:
        s.sendall(serve.MAGIC_Q + struct.pack("<II", serve.MODE_RGB,
                                              (256 << 20) + 1))
        head = s.recv(12)
    assert head[:4] == serve.MAGIC_R
    assert struct.unpack("<II", head[4:])[0] == serve.STATUS_ERROR


# -- continuous batching: the port's server and the JAX package's ------------

def _batched(impl):
    """A batching server of the port (on the CPU) or of the JAX package."""
    if impl == "port":
        return _start(serve.DecodeServer(("127.0.0.1", 0), device="cpu",
                                         batch_window_s=0.25, max_batch=4))
    return _start(jserve.DecodeServer(("127.0.0.1", 0), backend="jax",
                                      batch_window_s=0.25, max_batch=4))


def _poisoned(clip: bytes) -> bytes:
    """A clip whose second GOP block fails to plan (stream-size entry of
    0xFFFFFFFF): it demuxes, then poisons its own stream in the batch."""
    body = 0x44
    (len0,) = struct.unpack_from(">I", clip, body)
    out = bytearray(clip)
    struct.pack_into(">I", out, body + 8 + len0 + 8 + 8 + 12, 0xFFFFFFFF)
    return bytes(out)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_continuous_batching_matches_unbatched(servers, impl):
    """Three concurrent 64x48 requests coalesce into one or two batches,
    each reply byte-equal to the unbatched port server's; a truncated clip
    fails at its demux and a poisoned one inside the batch, each alone."""
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPB"], seed=95 + i) for i in range(3)]
    truncated = make_clip(cfg, ["IPB"], seed=99)[:-30]
    poisoned = _poisoned(make_clip(cfg, ["IPB", "IPB"], seed=98))
    modes = [serve.MODE_YUV, serve.MODE_RGB, serve.MODE_YUV]
    want = [serve.decode_remote(*servers[0].server_address, c, mode=m)
            for c, m in zip(clips, modes)]
    srv = _batched(impl)
    host, p = srv.server_address
    try:
        results, errs = {}, {}

        def req(i, clip, mode):
            try:
                results[i] = serve.decode_remote(host, p, clip, mode=mode)
            except RuntimeError as e:
                errs[i] = str(e)

        jobs = list(zip(clips + [truncated, poisoned],
                        modes + [serve.MODE_YUV] * 2))
        threads = [threading.Thread(target=req, args=(i, c, m))
                   for i, (c, m) in enumerate(jobs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert not any(th.is_alive() for th in threads)
        assert [results.get(i) for i in range(3)] == want
        assert sorted(errs) == [3, 4] and "poisoned" in errs[4]
        m = serve.fetch_metrics(host, p)
        assert m["batched_requests"] == 4 and m["errors"] == 2
        assert 1 <= m["batches"] <= 2, m
    finally:
        _stop(srv)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_mux_batching_coalesces(servers, impl):
    """Concurrent submissions over ONE mux connection coalesce too."""
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IP"], seed=130 + i) for i in range(3)]
    want = [serve.decode_remote(*servers[0].server_address, c) for c in clips]
    srv = _batched(impl)
    try:
        with serve.MuxClient(*srv.server_address) as mc:
            ids = [mc.submit(c) for c in clips]
            assert [mc.result(rid, timeout=180) for rid in ids] == want
        m = serve.fetch_metrics(*srv.server_address)
        assert m["batched_requests"] == 3
        assert 1 <= m["batches"] <= 2, m
    finally:
        _stop(srv)


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_batch_metrics_in_json_and_prometheus(impl):
    srv = _batched(impl)
    try:
        host, p = srv.server_address
        clip = make_clip(SeqConfig(32, 16), ["IP"], seed=9)
        assert len(serve.decode_remote(host, p, clip)) == 2
        m = serve.fetch_metrics(host, p)
        assert (m["batches"], m["batched_requests"],
                m["batch_size_last"]) == (1, 1, 1)
        (prom,) = serve.decode_remote(host, p, b"",
                                      mode=serve.MODE_METRICS_PROM)
        lines = prom.decode().splitlines()
        for line in ("# TYPE hvqm4_serve_batches_total counter",
                     "hvqm4_serve_batches_total 1",
                     "hvqm4_serve_batched_requests_total 1",
                     "# TYPE hvqm4_serve_batch_size_last gauge",
                     "hvqm4_serve_batch_size_last 1"):
            assert line in lines
    finally:
        _stop(srv)


def test_main_batching_flags_reach_the_server(monkeypatch, capsys):
    seen = {}

    class Recorder:
        def __init__(self, addr, **kw):
            seen.update(kw, addr=addr)
            self.device = kw["device"]
            self.batching = kw["batch_window_s"] > 0
            self.max_batch = kw["max_batch"]

        def serve_forever(self):
            seen["served"] = True

        def server_close(self):
            pass

    monkeypatch.setattr(serve, "DecodeServer", Recorder)
    monkeypatch.setattr(serve.signal, "signal", lambda *args: None)
    assert serve.main(["--port", "0", "--device", "cpu",
                       "--batch-window-ms", "250", "--max-batch", "4"]) == 0
    assert seen["batch_window_s"] == 0.25 and seen["max_batch"] == 4
    assert seen["served"]
    assert "batch window 250.0 ms, max 4" in capsys.readouterr().err
    # the real server admits a whole batch at once, whatever max_pending
    monkeypatch.undo()
    real = _start(serve.DecodeServer(("127.0.0.1", 0), device="cpu",
                                     batch_window_s=0.25, max_batch=16,
                                     max_pending=2))
    try:
        assert real.batching and real.max_batch == 16
        assert all(real.admission.acquire(blocking=False) for _ in range(16))
    finally:
        _stop(real)


def test_main_without_cuda_fails_with_one_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    assert serve.main(["--port", "0"]) == 1
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and "CUDA is not available" in err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.DecodeServer(("127.0.0.1", 0), device="cuda")


@pytest.mark.parametrize("samp", [2, 1])
def test_cli_ppm_and_y4m_match_jax(tmp_path, samp):
    cfg = SeqConfig(64, 48, samp, samp)
    clip = tmp_path / "c.h4m"
    clip.write_bytes(make_clip(cfg, ["IPBPB", "IP"], seed=60 + samp))
    assert cli.main(["decode", str(clip), "--device", "cpu", "--ppm",
                     str(tmp_path / "t")]) == 0
    assert jcli.main(["decode", str(clip), "--backend", "numpy", "--ppm",
                      str(tmp_path / "j")]) == 0
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert len(names) == 7
    assert sorted(f.name for f in (tmp_path / "t").iterdir()) == names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n
    assert cli.main(["decode", str(clip), str(tmp_path / "t.y4m"),
                     "--device", "cpu", "--y4m"]) == 0
    assert jcli.main(["decode", str(clip), str(tmp_path / "j.y4m"),
                      "--backend", "numpy", "--y4m"]) == 0
    y4m = (tmp_path / "t.y4m").read_bytes()
    assert y4m.startswith(b"YUV4MPEG2 W64 H48 ")
    assert y4m == (tmp_path / "j.y4m").read_bytes()
