"""serve.Batcher on a ("dp", "tp") mesh against the single-process Batcher,
on the CPU under gloo (one spawn of two ranks runs the dp = 2 and the tp =
2 mesh in turn, each rank building the Batcher with the same arguments and
rank 0 submitting), at SD_TINY in f32:

- three concurrent requests (a batch of 3, padded to 4) give the single
  process's images within 1 gray level, and so does the request of each
  adapter: one over the attention linears, one over GEGLU's projection
  (whose tp part is [value_r | gate_r]);
- a lone one-image request is served at dp = 2 (padded to 2);
- a request with no seed gives every rank the same initial latent (rank 0
  draws the seed before it broadcasts the batch);
- close() on rank 0 stops the followers; a follower's submit() raises;
- a batch that fails on one rank (rank 1's sampling raises, while rank 0
  waits in the sampling's collectives) ends the Batcher on both ranks within
  FAIL_WITHIN seconds: the batch's caller gets the error, later requests
  are refused, and both ranks' threads end.
"""

import threading
import time

import numpy as np
import pytest
import torch

from test_torch_parallel import SPAWN_TIMEOUT

WINDOW_MS = 1500.0  # the three concurrent submits arrive well inside it
LAYOUTS = {"dp": (2, 1), "tp": (1, 2)}
# (prompt, steps, scale, seed, n_images, negative, sampler, karras, lora)
CONCURRENT = (("a mossy stone", 2, 7.5, 1, 1, "", "ddim", False, None),
              ("a lighthouse at dusk", 2, 5.0, 2, 1, "blurry", "ddim", False, None),
              ("a red fox", 2, 7.5, 3, 1, "", "ddim", False, None))
LONE = ("an old map", 2, 7.5, 4, 1, "", "euler", False, None)
UNSEEDED = ("a quiet harbour", 2, 7.5, None, 1, "", "ddim", False, None)
FAIL_WITHIN = 60.0
ADAPTED = {name: ("a mossy stone", 2, 7.5, 5, 1, "", "ddim", False, name)
           for name in ("ink", "geglu")}


def _pipeline(mesh=None):
    from sdtpu_torch.config import SD_TINY
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.weights import init_params

    params = init_params(SD_TINY, torch.Generator().manual_seed(0), device="cpu")
    return StableDiffusion(params, SD_TINY, mesh=mesh), params


def _adapter(params):
    """Two rank-2 adapters whose b is not 0: "ink" over the UNet's attention
    linears, "geglu" over GEGLU's projection."""
    from sdtpu_torch.lora import DEFAULT_TARGETS, init_lora
    from sdtpu_torch.models.unet import unfuse_qkv

    g = torch.Generator().manual_seed(11)

    def rec(node):
        if "b" in node and "a" in node:
            return {"a": node["a"], "b": 0.2 * torch.randn(node["b"].shape, generator=g)}
        return {k: rec(v) for k, v in node.items()}

    return {name: (rec(init_lora(g, unfuse_qkv(params["unet"]), rank=2, targets=targets)), 0.5)
            for name, targets in (("ink", DEFAULT_TARGETS), ("geglu", ("proj", "fc1")))}


def _requests(batcher):
    """Rank 0's (or the single process's) requests, in order: three at once,
    a lone one, an unseeded one, each adapter's. Returns their images."""
    out = [None] * len(CONCURRENT)

    def one(i):
        out[i] = batcher.submit(*CONCURRENT[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(CONCURRENT))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return {"concurrent": out, "lone": batcher.submit(*LONE),
            "unseeded": batcher.submit(*UNSEEDED),
            "adapted": {name: batcher.submit(*req) for name, req in ADAPTED.items()}}


def _serve_rank():
    import torch.distributed as dist

    from sdtpu_torch import serve
    from sdtpu_torch.parallel import make_mesh
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer

    torch.set_num_threads(1)
    seen = []  # the initial latent of every batch this rank ran
    sample_latent = StableDiffusion.sample_latent

    def spy(self, *a, **k):
        seen.append(k["initial_latent"].clone())
        return sample_latent(self, *a, **k)

    StableDiffusion.sample_latent = spy
    out = {}
    for name, (dp, tp) in LAYOUTS.items():
        mesh = make_mesh(dp=dp, tp=tp, device="cpu")
        sd, params = _pipeline(mesh)
        batcher = serve.Batcher(sd, SimpleTokenizer(), max_batch=4, window_ms=WINDOW_MS,
                                timeout_s=600, loras=_adapter(params))
        seen.clear()
        res = {"rank": dist.get_rank()}
        if mesh.rank == 0:
            res["images"] = _requests(batcher)
            try:
                serve.make_server(sd, SimpleTokenizer(), port=0, warmup=False)
            except ValueError as e:
                res["server"] = str(e)
            batcher.close(timeout=60)
        else:
            try:
                batcher.submit(*LONE)
            except RuntimeError as e:
                res["submit"] = str(e)
            batcher.close(timeout=600)
        res["stopped"] = not batcher.thread.is_alive()
        res["latents"] = [x.clone() for x in seen]
        res["batch_sizes"] = dict(batcher.batch_sizes)
        out[name] = res
        dist.barrier()
    return out


@pytest.fixture(scope="module")
def mesh_runs():
    from sdtpu_torch.parallel import spawn

    return spawn(2, _serve_rank, backend="gloo", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def single():
    from sdtpu_torch import serve
    from sdtpu_torch.tokenizer import SimpleTokenizer

    torch.set_num_threads(1)
    sd, params = _pipeline()
    batcher = serve.Batcher(sd, SimpleTokenizer(), max_batch=4, window_ms=WINDOW_MS,
                            timeout_s=600, loras=_adapter(params))
    try:
        return _requests(batcher), dict(batcher.batch_sizes)
    finally:
        batcher.close()


def _gray(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_batcher_images_equal_single(mesh_runs, single, layout):
    got, want = mesh_runs[0][layout]["images"], single[0]
    for g, w in zip(got["concurrent"] + list(got["adapted"].values()),
                    want["concurrent"] + list(want["adapted"].values())):
        assert g.shape == w.shape == (1, 32, 32, 3) and g.dtype == np.uint8
        assert _gray(g, w) <= 1
    # each adapter moved the image off the base's of the same request
    for name in ADAPTED:
        assert _gray(want["adapted"][name], want["concurrent"][0]) > 1
    # the three arrived as one batch, padded to 4, on every rank
    for res in mesh_runs:
        assert res[layout]["batch_sizes"].get(4) == 1


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_batcher_serves_a_lone_request(mesh_runs, single, layout):
    """A lone one-image request is padded to a multiple of dp (2 at dp = 2,
    1 at tp = 2) and served."""
    got = mesh_runs[0][layout]["images"]["lone"]
    assert got.shape == (1, 32, 32, 3) and _gray(got, single[0]["lone"]) <= 1
    pad = 2 if layout == "dp" else 1
    for res in mesh_runs:
        assert res[layout]["batch_sizes"].get(pad, 0) >= 1
        # every batch the rank ran was a multiple of dp
        assert all(x.shape[0] % LAYOUTS[layout][0] == 0 for x in res[layout]["latents"])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_batcher_unseeded_draws_agree(mesh_runs, layout):
    """Every rank ran every batch on the same initial latent, the unseeded
    request's among them."""
    a, b = (res[layout]["latents"] for res in mesh_runs)
    assert len(a) == len(b) == 3 + len(ADAPTED)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_batcher_close_stops_the_followers(mesh_runs, layout):
    leader, follower = (res[layout] for res in mesh_runs)
    assert leader["rank"] == 0 and leader["stopped"]
    assert follower["stopped"]
    assert "rank 0 takes the requests" in follower["submit"]
    assert "without a mesh" in leader["server"]


def _failing_rank(dp, tp):
    """One rank of a mesh Batcher whose second batch fails on rank 1 (its
    sample_latent raises). Rank 0 submits a request, the failing one and one more;
    returns what each rank saw."""
    import torch.distributed as dist

    from sdtpu_torch import serve
    from sdtpu_torch.parallel import make_mesh
    from sdtpu_torch.pipeline import StableDiffusion
    from sdtpu_torch.tokenizer import SimpleTokenizer

    torch.set_num_threads(1)
    rank = dist.get_rank()
    sample, calls = StableDiffusion.sample_latent, []

    def faulty(self, *a, **k):
        calls.append(1)
        if rank == 1 and len(calls) == 2:
            raise RuntimeError("planted failure on rank 1")
        return sample(self, *a, **k)

    StableDiffusion.sample_latent = faulty
    sd, _ = _pipeline(make_mesh(dp=dp, tp=tp, device="cpu"))
    batcher = serve.Batcher(sd, SimpleTokenizer(), max_batch=4, window_ms=0.0, timeout_s=600)
    res = {"rank": rank}
    if rank == 0:
        res["first"] = batcher.submit(*CONCURRENT[0]).shape
        t0 = time.monotonic()
        try:
            batcher.submit(*CONCURRENT[1])
        except RuntimeError as e:
            res["second"] = str(e)
        res["second_s"] = time.monotonic() - t0
        try:
            batcher.submit(*LONE)
        except RuntimeError as e:
            res["third"] = str(e)
        batcher.close(timeout=FAIL_WITHIN)
    else:
        batcher.close(timeout=FAIL_WITHIN)
    res["stopped"] = not batcher.thread.is_alive()
    res["failed"] = batcher.failed
    res["world"] = dist.is_initialized()
    return res


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_batcher_failure_ends_every_rank(layout):
    from sdtpu_torch.parallel import spawn

    leader, follower = spawn(2, _failing_rank, *LAYOUTS[layout], backend="gloo",
                             timeout=SPAWN_TIMEOUT)
    assert leader["first"] == (1, 32, 32, 3)
    assert leader["second_s"] < FAIL_WITHIN
    assert "Connection closed" in leader["second"] and "the mesh failed" in leader["third"]
    assert "planted failure on rank 1" in follower["failed"]
    for res in (leader, follower):
        assert res["stopped"] and res["failed"] and not res["world"]
