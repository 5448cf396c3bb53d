"""The port's HTTP server (sdtpu_torch.serve), at the tiny config of
tests/test_pipeline.py on the CPU, driven through its socket as
tests/test_serve.py drives sdtpu's: healthz, a generate round trip, 400s,
concurrent batching, mixed samplers, karras, the image endpoints, 503 and
504, the context cache, LoRA adapters (a request, an unknown name, the
merged-pipeline cache, the --lora spec), and a lone seeded request against
StableDiffusion.generate with the same seed.
"""

import base64
import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from sdtpu_torch import serve
from sdtpu_torch.config import config_from_dict
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.tokenizer import SimpleTokenizer
from sdtpu_torch.utils.image import decode_png_rgb8, encode_png_rgb8
from sdtpu_torch.weights import from_numpy_tree
from test_pipeline import TINY
from test_torch_lora import host_params, nonzero_lora

torch.set_num_threads(1)

CFG = config_from_dict(dataclasses.asdict(TINY))  # the port's copy of the config


@pytest.fixture(scope="module")
def sd():
    return StableDiffusion(from_numpy_tree(host_params(), device="cpu"), CFG)


@pytest.fixture(scope="module")
def lora_tree(sd):
    return from_numpy_tree(nonzero_lora(host_params()["unet"]), device="cpu")


@pytest.fixture(scope="module")
def server(sd, lora_tree):
    srv = serve.make_server(sd, SimpleTokenizer(), port=0, warmup=True, default_steps=2,
                            batch_window_ms=200.0, loras={"style": (lora_tree, 4.0)})
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=30)
    assert not t.is_alive() and not srv.state.batcher.thread.is_alive()


@pytest.fixture(scope="module")
def port(server):
    return server.server_address[1]


def _post(port, payload, path="/generate"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _img(resp, i=0):
    return decode_png_rgb8(base64.b64decode(resp["images"][i]))


def _mask_b64():
    mask = np.zeros((32, 32, 3), np.uint8)
    mask[8:24, 8:24] = 255
    return base64.b64encode(encode_png_rgb8(mask)).decode()


def test_healthz(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        assert r.status == 200 and json.loads(r.read()) == {"ready": True}


def test_generate_roundtrip(port):
    code, resp = _post(port, {"prompt": "a stone", "steps": 2, "seed": 7})
    assert code == 200, resp
    assert len(resp["images"]) == 1 and _img(resp).shape == (32, 32, 3)
    assert resp["latency_s"] > 0 and resp["images_per_sec"] > 0
    code2, resp2 = _post(port, {"prompt": "a stone", "steps": 2, "seed": 7})
    assert resp2["images"] == resp["images"]  # the same seed, the same image
    code, resp = _post(port, {"prompt": "a stone", "steps": 2, "seed": 7, "n_images": 2})
    assert code == 200 and len(resp["images"]) == 2


@pytest.mark.parametrize("sampler", ["ddim", "euler_a"])
def test_lone_request_equals_generate(port, sd, sampler):
    """A lone seeded request: its latent and draws from a generator seeded
    with the seed on the pipeline's device, as generate() takes them."""
    code, resp = _post(port, {"prompt": "a stone", "steps": 3, "seed": 11,
                              "negative_prompt": "blurry", "guidance_scale": 6.0,
                              "sampler": sampler})
    assert code == 200, resp
    want = sd.generate(SimpleTokenizer(), "a stone", 6.0, 3, sampler=sampler,
                       negative_prompt="blurry",
                       generator=torch.Generator(device=sd.device).manual_seed(11))
    np.testing.assert_array_equal(_img(resp), want[0])


def test_bad_requests(port):
    for payload, word in (({"steps": 2}, "prompt"), ({"prompt": "x", "steps": 0}, "steps"),
                          ({"prompt": "x", "n_images": 99}, "n_images"),
                          ({"prompt": "a", "sampler": "plms"}, "sampler"),
                          ({"prompt": "a", "karras": True}, "karras"),
                          ({"prompt": "a", "sampler": "euler", "karras": "false"}, "boolean"),
                          ({"prompt": "a", "seed": "x"}, "")):
        code, resp = _post(port, payload)
        assert code == 400 and word in resp["error"], (payload, resp)
    code, resp = _post(port, {"prompt": "x"}, path="/img2img")
    assert code == 400 and "init_image" in resp["error"]
    code, resp = _post(port, {"prompt": "x", "init_image": "", "strength": 1.5},
                       path="/img2img")
    assert code == 400
    code, resp = _post(port, {"prompt": "x", "init_image": ""}, path="/inpaint")
    assert code == 400 and "mask" in resp["error"]
    code, _ = _post(port, {"prompt": "x"}, path="/nope")
    assert code == 404


def test_concurrent_requests_batch(server, port):
    """Four requests of one key in flight together run as one batch of 4,
    each with its own seed and guidance scale."""
    before = server.state.batcher.batch_sizes[4]
    results = [None] * 4
    barrier = threading.Barrier(4)

    def call(i):
        barrier.wait()
        results[i] = _post(port, {"prompt": f"stone {i}", "steps": 2, "seed": i,
                                  "guidance_scale": 5.0 + i})

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(code == 200 for code, _ in results), results
    assert len({r["images"][0] for _, r in results}) == 4
    assert server.state.batcher.batch_sizes[4] == before + 1


def test_mixed_samplers_and_karras(port):
    results = {}

    def go(name, payload):
        results[name] = _post(port, payload)

    payloads = {"ddim": {"prompt": "a", "steps": 2, "seed": 1},
                "dpmpp": {"prompt": "a", "steps": 2, "seed": 1, "sampler": "dpmpp"},
                "heun": {"prompt": "a", "steps": 2, "seed": 1, "sampler": "heun"},
                "euler_k": {"prompt": "a", "steps": 2, "seed": 1, "sampler": "euler",
                            "karras": True},
                "euler": {"prompt": "a", "steps": 2, "seed": 1, "sampler": "euler"}}
    threads = [threading.Thread(target=go, args=kv) for kv in payloads.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    for name, (code, resp) in results.items():
        assert code == 200, (name, resp)
    images = {name: r["images"][0] for name, (_, r) in results.items()}
    assert len(set(images.values())) == len(images)  # each sampler its own image


def test_image_endpoints(port):
    code, resp = _post(port, {"prompt": "a stone", "steps": 2, "seed": 3})
    init = resp["images"][0]
    req = {"prompt": "a mossy stone", "init_image": init, "strength": 0.5, "steps": 4,
           "seed": 4}
    code, a = _post(port, req, path="/img2img")
    assert code == 200, a
    assert _img(a).shape == (32, 32, 3)
    assert _post(port, req, path="/img2img")[1]["images"] == a["images"]  # deterministic
    code, k = _post(port, {**req, "sampler": "euler", "karras": True}, path="/img2img")
    assert code == 200 and k["images"] != a["images"]
    # euler_a's per-step draws come from the request's seed too
    ea_req = {**req, "sampler": "euler_a"}
    code, ea = _post(port, ea_req, path="/img2img")
    assert code == 200 and ea["images"] != a["images"]
    assert _post(port, ea_req, path="/img2img")[1]["images"] == ea["images"]
    inp ={"prompt": "a mossy stone", "init_image": init, "mask": _mask_b64(), "steps": 2,
           "seed": 6, "sampler": "dpmpp"}
    code, m = _post(port, inp, path="/inpaint")
    assert code == 200, m
    code, mk = _post(port, {**inp, "karras": True}, path="/inpaint")
    assert code == 200 and mk["images"] != m["images"]
    # the kept region (mask 0) stays close to the init image, the box does not
    img, ref = _img(m).astype(int), decode_png_rgb8(base64.b64decode(init)).astype(int)
    assert np.abs(img - ref)[:4].mean() < np.abs(img - ref)[12:20, 12:20].mean()


def _batcher(sd, **kw):
    return serve.Batcher(sd, SimpleTokenizer(), **kw)


def test_queue_overflow_503(sd):
    b = _batcher(sd, max_batch=1, window_ms=1.0, max_queue=1)
    try:
        t = threading.Thread(target=lambda: b.submit("x", 8, 7.5, 0, 1, ""), daemon=True)
        t.start()
        raised, deadline = False, time.monotonic() + 30
        while not raised and time.monotonic() < deadline:
            # an abandoned slot in the queue while the worker is busy
            b.queue.put(("y", 2, 7.5, 0, 1, "", "ddim", False, None, threading.Event(),
                         {"abandoned": True}))
            try:
                b.submit("z", 2, 7.5, 0, 1, "")
            except serve.Overloaded:
                raised = True
        assert raised
        t.join(timeout=60)
    finally:
        b.close()


def test_request_timeout_504(sd):
    b = _batcher(sd, timeout_s=0.0)
    try:
        with pytest.raises(serve.RequestTimeout):
            b.submit("slow", 2, 7.5, 0, 1, "")
    finally:
        b.close()


def test_context_cache_hits_and_bounds(sd):
    tok = SimpleTokenizer()
    b = _batcher(sd, ctx_cache_size=2)
    cold = _batcher(sd, ctx_cache_size=0)
    try:
        c1 = b._context_cached("an ancient mossy stone")
        assert b._context_cached("an ancient mossy stone")[0] is c1[0]  # a hit
        torch.testing.assert_close(c1[0], sd.context(tok, "an ancient mossy stone")[0])
        b._context_cached("")
        b._context_cached("a third prompt")  # evicts the oldest
        assert len(b._ctx_cache) == 2 and "an ancient mossy stone" not in b._ctx_cache
        np.testing.assert_array_equal(b.submit("an ancient mossy stone", 2, 7.5, 11, 1, ""),
                                      cold.submit("an ancient mossy stone", 2, 7.5, 11, 1, ""))
    finally:
        b.close()
        cold.close()


# ---------------------------------------------------------------- LoRA


def test_lora_request(port):
    base = {"prompt": "a stone", "steps": 2, "seed": 21}
    code, plain = _post(port, base)
    code, adapted = _post(port, {**base, "lora": "style"})
    assert code == 200, adapted
    assert adapted["images"][0] != plain["images"][0]
    assert _post(port, {**base, "lora": "style"})[1]["images"] == adapted["images"]
    assert _post(port, {**base, "lora": ""})[1]["images"] == plain["images"]  # "" = none
    req = {"prompt": "a mossy stone", "init_image": plain["images"][0], "strength": 0.5,
           "steps": 2, "seed": 23}
    code, img_plain = _post(port, req, path="/img2img")
    code, img_lora = _post(port, {**req, "lora": "style"}, path="/img2img")
    assert code == 200 and img_lora["images"] != img_plain["images"]


def test_lora_unknown_rejected(port):
    code, resp = _post(port, {"prompt": "a", "lora": "nope"})
    assert code == 400 and "nope" in resp["error"] and "style" in resp["error"]


def test_sd_for_caches_merged_pipeline(sd, lora_tree):
    from sdtpu_torch.io.native import flatten_tree
    from sdtpu_torch.lora import apply_lora
    from sdtpu_torch.models.unet import fuse_qkv, unfuse_qkv

    b = _batcher(sd, loras={"s": (lora_tree, 4.0)})
    try:
        assert b.sd_for(None) is sd and b.sd_for("") is sd
        one = b.sd_for("s")
        assert b.sd_for("s") is one  # merged once
        with pytest.raises(ValueError, match="unknown lora"):
            b.sd_for("missing")
        # the merged pipeline's fused attn1 q/k/v are the merged weights
        want = fuse_qkv(apply_lora(unfuse_qkv(sd.params["unet"]), lora_tree, 4.0))
        got = flatten_tree(one.params["unet"])
        for k, v in flatten_tree(want).items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
        assert any(k.endswith("attn1/qkv/w") for k in got)
        # the CLIP and VAE weights are the base pipeline's tensors
        for part in ("clip", "autoencoder"):
            mine, base = flatten_tree(one.params[part]), flatten_tree(sd.params[part])
            assert mine.keys() == base.keys()
            assert all(mine[k] is base[k] for k in base)
    finally:
        b.close()


def test_load_loras_spec(tmp_path, lora_tree):
    from sdtpu_torch.lora import save_lora

    p1, p2 = str(tmp_path / "styleA.lora.safetensors"), str(tmp_path / "b.safetensors")
    save_lora(lora_tree, p1, rank=2, alpha=4.0)
    save_lora(lora_tree, p2, rank=2, alpha=2.0)
    loras = serve.load_loras(f"{p1},mystyle={p2}")
    assert set(loras) == {"styleA", "mystyle"}
    assert loras["styleA"][1] == 2.0 and loras["mystyle"][1] == 1.0
    with pytest.raises(ValueError, match="duplicate"):
        serve.load_loras(f"x={p1},x={p2}")


def test_main_wires_lora_and_refuses_other_formats(tmp_path, monkeypatch, sd, lora_tree):
    from sdtpu_torch.io import native
    from sdtpu_torch.lora import save_lora

    p1 = str(tmp_path / "styleA.lora.safetensors")
    save_lora(lora_tree, p1, rank=2, alpha=4.0)
    captured = {}

    class _Started(Exception):
        pass

    class _Server:
        def serve_forever(self):
            raise _Started()

        def server_close(self):
            captured["closed"] = True

    def fake_make_server(sd_, tok, port, default_steps=20, loras=None, **kw):
        captured.update(port=port, steps=default_steps, loras=loras, dtype=sd_.compute_dtype)
        return _Server()

    def fake_load_native(path, device="cuda"):
        captured["device"] = device
        return sd.params, CFG

    monkeypatch.setattr(serve, "make_server", fake_make_server)
    monkeypatch.setattr(native, "load_native", fake_load_native)
    with pytest.raises(_Started):
        serve.main(["serve", "native", "x.safetensors", "--lora", p1, "--port", "9",
                    "--bf16", "--steps", "3"])
    assert set(captured["loras"]) == {"styleA"} and captured["device"] == "cuda"
    assert (captured["port"], captured["steps"], captured["dtype"]) == (9, 3, torch.bfloat16)
    assert captured["closed"]
    with pytest.raises(ValueError, match="item 12"):
        serve.main(["serve", "ckpt", "x.ckpt"])
    with pytest.raises(SystemExit):  # a bare trailing flag prints the usage
        serve.main(["serve", "native", "x.safetensors", "--lora"])
