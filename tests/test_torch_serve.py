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
        assert m["errors"] == 0 and "batches" not in m  # no batching
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


def test_main_refuses_batching_with_one_line(capsys):
    assert serve.main(["--port", "0", "--device", "cpu",
                       "--batch-window-ms", "5"]) == 1
    err = capsys.readouterr().err.strip()
    assert len(err.splitlines()) == 1 and "--batch-window-ms" in err


def test_main_has_no_max_batch_flag(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--port", "0", "--device", "cpu", "--max-batch", "16"])
    assert e.value.code == 2
    assert "unrecognized arguments: --max-batch" in capsys.readouterr().err


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
