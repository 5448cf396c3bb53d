"""One captured program per user action (sdtpu_torch/graphs.py), tested at
sd-tiny.

On the CPU:
- (a) the sampler makes every random draw before its loop: its latents
  equal, bit for bit, those of the loop that drew step by step (the
  sampler as it was, kept here as _interleaved), for every sampler, the
  Karras ladders, a mid-schedule start (img2img), inpainting, per-item
  guidance and the two-pass mode, through a torch.Generator and through
  draw_noise;
- (b) the graph key holds every name of sdtpu's _sample_latent_impl
  static_argnames (read from sdtpu/pipeline.py), and two calls that differ
  in one of them, in a shape, in the guidance's form, in the masks, in
  the parameter tree or in a dispatch gate get different keys;
- (c) launch accounting: a capture's launches go into its record, not to
  the counters, and N replays add N times the record, per shape;
- (d) graphs=True on a CPU pipeline raises, and WarmStart re-raises a
  build failure at join().

On the card (marked cuda, skipped here): each sampler, img2img and
inpainting replayed against the eager loop on the same inputs, two seeds
and two prompts through one graph (stale buffers), two graphs replayed in
turns, the decode, CLIP and the encoder, and the launch counts of N
replays against N eager calls, per shape.
"""

import ast
import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from sdtpu_torch import graphs, kernels, warm
from sdtpu_torch.config import SD_TINY
from sdtpu_torch.diffusion.ddim import ddim_alphas, ddim_schedule, ddim_step
from sdtpu_torch.diffusion.dpm_solver import (dpmpp_2m_step, dpmpp_arrays, dpmpp_init,
                                             dpmpp_karras_arrays)
from sdtpu_torch.diffusion.karras import (euler_ancestral_step, euler_step, heun_step,
                                         karras_arrays, karras_sigma_arrays, model_input,
                                         vp_alpha)
from sdtpu_torch.models import unet as unet_model
from sdtpu_torch.models import vae as vae_model
from sdtpu_torch.models.unet import unet_apply
from sdtpu_torch.ops import attention, conv, dispatch, groupnorm
from sdtpu_torch.pipeline import StableDiffusion, to_eps
from sdtpu_torch.weights import init_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
D = SD_TINY.unet.context_dim
HW = SD_TINY.latent_size


def _params(device="cpu", cfg=SD_TINY):
    return init_params(cfg, torch.Generator(device=device).manual_seed(0), device=device)


PARAMS = _params()
SD = StableDiffusion(PARAMS, SD_TINY)  # the pipeline of the key tests' base calls


def _interleaved(sd, context, unconditional_context, scale, n_steps, generator=None,
                 initial_latent=None, ctx_valid=None, uncond_valid=None, sampler="ddim",
                 skip_steps=0, karras_sigmas=False, known_latent=None, known_mask=None,
                 draw_noise=None):
    """The sampler as it ran before its draws moved out of the loop (one
    device, no mesh): euler_a's noise and the re-imposition's drawn inside
    each step, the timesteps passed as Python numbers."""
    cfg, dev = sd.config, sd.device
    draw_noise = draw_noise or sd._draw_from(generator)
    b = context.shape[0]
    if initial_latent is None:
        initial_latent = draw_noise((b, cfg.latent_size, cfg.latent_size,
                                     cfg.unet.in_channels))
    lat = torch.as_tensor(initial_latent, dtype=torch.float32).to(dev)

    def noise_like(x):
        return torch.as_tensor(draw_noise((b,) + tuple(x.shape[1:])),
                               dtype=torch.float32).to(dev)

    unet, dt = sd.params["unet"], sd.compute_dtype
    scale = torch.as_tensor(scale, dtype=torch.float32).to(dev)
    if scale.ndim == 1:
        scale = scale[:, None, None, None]
    uncond_b = unconditional_context.expand((b,) + unconditional_context.shape[1:])
    if sd.pad_context:
        ctx2 = torch.cat([uncond_b, context], dim=0)
        valid2 = (None if ctx_valid is None else torch.cat(
            [uncond_valid.expand((b,) + uncond_valid.shape[1:]), ctx_valid], dim=0))

        def denoise(x, t):
            eps2 = unet_apply(unet, torch.cat([x, x], dim=0).to(dt), t, ctx2, cfg.unet,
                              ctx_valid=valid2).float()
            e_un, e_c = eps2[:b], eps2[b:]
            return e_un + (e_c - e_un) * scale
    else:
        def denoise(x, t):
            x = x.to(dt)
            e_un = unet_apply(unet, x, t, uncond_b, cfg.unet).float()
            e_c = unet_apply(unet, x, t, context, cfg.unet).float()
            return e_un + (e_c - e_un) * scale

    kind = cfg.prediction_type
    inpaint = known_latent is not None
    if inpaint:
        z0 = torch.as_tensor(known_latent, dtype=torch.float32).to(dev)
        mask = torch.as_tensor(known_mask, dtype=torch.float32).to(dev)

    def reimpose(x, alpha, sigma):
        if not inpaint:
            return x
        known = alpha * z0 + sigma * noise_like(z0)
        return mask * x + (1.0 - mask) * known

    alphas = sd.params["alphas_cumprod"].float()
    ac = alphas.cpu().numpy()

    def table(a):
        return torch.from_numpy(np.ascontiguousarray(a[skip_steps:])).to(dev)

    if sampler == "ddim":
        timesteps, step_size = ddim_schedule(sd.n_train_steps, n_steps)
        timesteps = timesteps[skip_steps:]
        a_t, a_prev = ddim_alphas(alphas, timesteps, step_size)
        for i, t in enumerate(timesteps):
            eps = to_eps(denoise(lat, t), lat, a_t[i], kind)
            lat = ddim_step(lat, eps, a_t[i], a_prev[i])
            lat = reimpose(lat, torch.sqrt(a_prev[i]), torch.sqrt(1.0 - a_prev[i]))
        return lat
    if sampler == "dpmpp":
        arrs = (dpmpp_karras_arrays(ac, n_steps) if karras_sigmas
                else dpmpp_arrays(ac, sd.n_train_steps, n_steps))
        steps = [table(a) for a in arrs[:6]]
        state = dpmpp_init(lat)
        for i, t in enumerate(arrs.timesteps[skip_steps:]):
            step = [a[i] for a in steps]
            eps = to_eps(denoise(state.x, t), state.x, step[0] * step[0], kind)
            state = dpmpp_2m_step(state, eps, step)
            state = state._replace(x=reimpose(state.x, step[3], step[4]))
        return state.x
    arrs = (karras_sigma_arrays(ac, n_steps) if karras_sigmas
            else karras_arrays(ac, sd.n_train_steps, n_steps))
    sig, sig_next = table(arrs.sigma), table(arrs.sigma_next)
    x = lat * torch.sqrt(sig[0] ** 2 + 1.0)

    def eps_at(x, sigma, t):
        inp = model_input(x, sigma)
        return to_eps(denoise(inp, t), inp, vp_alpha(sigma), kind)

    for i, (t, tn) in enumerate(zip(arrs.timesteps[skip_steps:], arrs.t_next[skip_steps:])):
        sg, sn = sig[i], sig_next[i]
        if sampler == "euler":
            x = euler_step(x, eps_at(x, sg, t), sg, sn)
        elif sampler == "heun":
            e1 = eps_at(x, sg, t)
            e2 = eps_at(euler_step(x, e1, sg, sn), torch.clamp(sn, min=1e-20), tn)
            x = heun_step(x, e1, e2, sg, sn)
        else:
            noise = noise_like(x)
            x = euler_ancestral_step(x, eps_at(x, sg, t), noise, sg, sn)
        x = reimpose(x, 1.0, sn)
    return x


# case -> its sample_latent arguments beyond the contexts; "pad": the
# pipeline's pad_context, "b": the batch, "initial": an injected latent
CASES = {
    "ddim": dict(sampler="ddim"),
    "dpmpp": dict(sampler="dpmpp"),
    "dpmpp_karras": dict(sampler="dpmpp", karras_sigmas=True),
    "euler": dict(sampler="euler"),
    "euler_karras": dict(sampler="euler", karras_sigmas=True),
    "euler_a": dict(sampler="euler_a"),
    "euler_a_karras": dict(sampler="euler_a", karras_sigmas=True),
    "heun": dict(sampler="heun"),
    "img2img_ddim": dict(sampler="ddim", skip_steps=1, initial=True),
    "img2img_euler_a": dict(sampler="euler_a", skip_steps=1, initial=True),
    "inpaint_ddim": dict(sampler="ddim", inpaint=True),
    "inpaint_dpmpp_karras": dict(sampler="dpmpp", karras_sigmas=True, inpaint=True),
    "inpaint_euler_a": dict(sampler="euler_a", inpaint=True),
    "inpaint_heun": dict(sampler="heun", inpaint=True),
    "per_item_euler_a": dict(sampler="euler_a", b=2, per_item=True),
    "twopass_euler_a": dict(sampler="euler_a", pad=False),
    "twopass_inpaint_ddim": dict(sampler="ddim", pad=False, inpaint=True),
}


def _inputs(case: dict, device="cpu", seed=3):
    """(pipeline kwargs, sample_latent args, sample_latent kwargs) of a case,
    from a numpy generator."""
    r = np.random.default_rng(seed)
    b, pad = case.get("b", 1), case.get("pad", True)

    def t(*shape):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(device)

    n_ctx = SD_TINY.clip.n_ctx if pad else 6
    ctx, unctx = t(b, n_ctx, D), t(1, n_ctx if pad else 4, D)
    kw = {k: case[k] for k in ("sampler", "skip_steps", "karras_sigmas") if k in case}
    if pad:
        kw["ctx_valid"] = torch.arange(n_ctx, device=device)[None, :].expand(b, -1) < 7
        kw["uncond_valid"] = torch.arange(n_ctx, device=device)[None, :] < 2
    if case.get("initial"):
        kw["initial_latent"] = t(b, HW, HW, 4)
    if case.get("inpaint"):
        kw["known_latent"] = t(b, HW, HW, 4)
        mask = torch.zeros((b, HW, HW, 1), device=device)
        mask[:, 2:6, 1:5] = 1.0
        kw["known_mask"] = mask
    scale = (torch.tensor([7.5, 3.0][:b], device=device) if case.get("per_item") else 7.5)
    return {"pad_context": pad}, (ctx, unctx, scale, STEPS), kw


def _numpy_draws(seed, shapes=None):
    """draw_noise from a numpy generator, recording each shape asked for."""
    r = np.random.default_rng(seed)

    def draw(shape):
        if shapes is not None:
            shapes.append(tuple(shape))
        return torch.from_numpy(r.standard_normal(tuple(shape)).astype(np.float32))
    return draw


# ------------------------------------------------------------ (a) the draws

@pytest.mark.parametrize("source", ["generator", "draw_noise"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_draws_before_the_loop_equal_the_interleaved_draws(name, source):
    case = CASES[name]
    sd_kw, args, kw = _inputs(case)
    sd = StableDiffusion(PARAMS, SD_TINY, **sd_kw)
    shapes = {"got": [], "want": []}

    def source_kw(which):
        if source == "generator":
            return {"generator": torch.Generator().manual_seed(11)}
        return {"draw_noise": _numpy_draws(11, shapes[which])}

    got = sd.sample_latent(*args, **kw, **source_kw("got"))
    want = _interleaved(sd, *args, **kw, **source_kw("want"))
    assert shapes["got"] == shapes["want"]
    assert torch.equal(got, want), float((got - want).abs().max())


def test_euler_a_inpaint_draw_order():
    """Each step draws euler_a's noise, then the re-imposition's; the
    initial latent comes first."""
    _, args, kw = _inputs(CASES["inpaint_euler_a"])
    shapes = []
    SD.sample_latent(*args, **kw, draw_noise=_numpy_draws(0, shapes))
    n_loop = len(ddim_schedule(SD.n_train_steps, STEPS)[0])  # sdtpu's grid: 4 for 3
    assert shapes == [(1, HW, HW, 4)] * (1 + 2 * n_loop)


# ------------------------------------------------------------ (b) the key

def _static_argnames() -> tuple:
    """sdtpu's _sample_latent_impl static_argnames, read from its source."""
    with open(os.path.join(REPO, "sdtpu", "pipeline.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "_sample_latent_impl")
    for dec in fn.decorator_list:
        if isinstance(dec, ast.Call):
            for kw in dec.keywords:
                if kw.arg == "static_argnames":
                    return tuple(ast.literal_eval(kw.value))
    raise AssertionError("no static_argnames on _sample_latent_impl")


def _key(sd=None, b=1, n_steps=STEPS, sampler="ddim", skip_steps=0, karras_sigmas=False,
         per_item=False, masks=True, inpaint=False, seed=0):
    sd = sd or SD
    case = {"b": b, "pad": sd.pad_context, "per_item": per_item, "inpaint": inpaint}
    _, (ctx, unctx, scale, _), kw = _inputs(case, seed=seed)
    if not masks:
        kw.pop("ctx_valid", None)
        kw.pop("uncond_valid", None)
    return sd._sampler_program(
        ctx, unctx, scale, n_steps, None, None, kw.get("ctx_valid"), kw.get("uncond_valid"),
        sampler, skip_steps, karras_sigmas, kw.get("known_latent"), kw.get("known_mask"),
        _numpy_draws(seed)).key


# each of sdtpu's static arguments -> (the base call's _key kwargs, the
# variant's): the variant differs from the base in that argument alone
STATIC_VARIANTS = {
    "config": lambda: ({}, {"sd": StableDiffusion(
        PARAMS, dataclasses.replace(SD_TINY, name="sd-tiny-other"))}),
    "compute_dtype": lambda: ({}, {"sd": StableDiffusion(PARAMS, SD_TINY,
                                                         compute_dtype=torch.bfloat16)}),
    "n_train_steps": lambda: ({}, {"sd": StableDiffusion({**PARAMS, "n_steps": 500},
                                                         SD_TINY)}),
    "n_steps": lambda: ({}, {"n_steps": STEPS + 1}),
    "parity_two_pass": lambda: ({}, {"sd": StableDiffusion(PARAMS, SD_TINY,
                                                           pad_context=False)}),
    "sampler": lambda: ({}, {"sampler": "euler"}),
    "skip_steps": lambda: ({}, {"skip_steps": 1}),
    "karras_sigmas": lambda: ({"sampler": "euler"}, {"sampler": "euler",
                                                     "karras_sigmas": True}),
}


def test_static_argnames_read_from_sdtpu():
    assert _static_argnames() == tuple(STATIC_VARIANTS)


@pytest.mark.parametrize("name", sorted(STATIC_VARIANTS))
def test_key_holds_each_static_argument(name):
    assert name in _static_argnames()
    base_kw, variant_kw = STATIC_VARIANTS[name]()
    base, variant = _key(**base_kw), _key(**variant_kw)
    assert name in graphs.key_fields(base)
    assert graphs.key_fields(base)[name] != graphs.key_fields(variant)[name]
    assert base != variant
    assert _key(**base_kw) == base  # the same call again: the same key


@pytest.mark.parametrize("variant", [{"b": 2}, {"per_item": True}, {"masks": False},
                                     {"inpaint": True}])
def test_key_holds_shapes_and_forms(variant):
    assert _key(**variant) != _key()
    assert _key(**variant, seed=5) == _key(**variant)  # new values, the same key


def test_key_holds_the_tree():
    sd = StableDiffusion(PARAMS, SD_TINY)
    other = sd.with_unet(_params()["unet"])
    assert _key(sd) != _key(other)
    assert graphs.key_fields(_key(sd))["trees"] == (id(sd.params["unet"]),)


GATES = {
    "FUSED_RES_MIN_ROWS": lambda mp: mp.setattr(unet_model, "FUSED_RES_MIN_ROWS", 64),
    "FUSED_CONV_MIN_ROWS": lambda mp: mp.setattr(vae_model, "FUSED_CONV_MIN_ROWS", 64),
    "FUSED_UP_MIN_ROWS": lambda mp: mp.setattr(conv, "FUSED_UP_MIN_ROWS", 64),
    "FUSED_GN_MIN_ROWS": lambda mp: mp.setattr(groupnorm, "FUSED_GN_MIN_ROWS", 64),
    "FLASH_MIN_SEQ": lambda mp: mp.setattr(attention, "FLASH_MIN_SEQ", 64),
    "SDTPU_FUSED_XATTN": lambda mp: mp.setenv("SDTPU_FUSED_XATTN", "1"),
    "matmul.allow_tf32": lambda mp: mp.setattr(torch.backends.cuda.matmul, "allow_tf32",
                                               not torch.backends.cuda.matmul.allow_tf32),
    "cudnn.allow_tf32": lambda mp: mp.setattr(torch.backends.cudnn, "allow_tf32",
                                              not torch.backends.cudnn.allow_tf32),
}


# the programs whose model reads each gate: flipping the gate changes
# their keys and leaves the others' alone
READERS = {
    "FUSED_RES_MIN_ROWS": {"sample"},
    "FUSED_CONV_MIN_ROWS": {"decode"},
    "FUSED_UP_MIN_ROWS": {"sample", "decode"},
    "FUSED_GN_MIN_ROWS": {"sample", "decode"},
    "FLASH_MIN_SEQ": {"sample", "decode", "clip"},
    "SDTPU_FUSED_XATTN": {"sample"},
    "matmul.allow_tf32": {"sample", "decode", "clip"},
    "cudnn.allow_tf32": {"sample", "decode", "clip"},
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_key_holds_each_gate(gate, monkeypatch):
    monkeypatch.delenv("SDTPU_FUSED_XATTN", raising=False)
    sd = StableDiffusion(PARAMS, SD_TINY)
    latent = torch.zeros((1, HW, HW, 4))
    tokens = torch.zeros((1, 77), dtype=torch.long)
    keys = {"sample": _key, "decode": lambda: sd._decode_program(latent).key,
            "clip": lambda: sd._clip_program(tokens).key}
    before = {kind: k() for kind, k in keys.items()}
    GATES[gate](monkeypatch)
    after = {kind: k() for kind, k in keys.items()}
    assert {kind for kind in keys if before[kind] != after[kind]} == READERS[gate]
    for kind in READERS[gate]:
        fields = graphs.key_fields(before[kind])["gates"], graphs.key_fields(after[kind])["gates"]
        assert fields[0][gate] != fields[1][gate]


def test_key_holds_training():
    before = _key()
    with dispatch.training():
        assert _key() != before


def test_other_programs_key_on_shape():
    sd = StableDiffusion(PARAMS, SD_TINY)
    tok = torch.zeros((1, 77), dtype=torch.long)
    assert sd._clip_program(tok).key == sd._clip_program(tok + 1).key
    assert sd._clip_program(tok).key != sd._clip_program(tok[:, :9]).key
    lat = torch.zeros((1, HW, HW, 4))
    assert sd._decode_program(lat).key != sd._decode_program(torch.cat([lat, lat])).key


# ------------------------------------------------------------ (c) accounting

def _fake_wrapper():
    def wrapper():
        pass
    wrapper.launches, wrapper.shapes, wrapper.launches_x2 = 0, {}, 0
    return wrapper


@pytest.fixture
def launched(monkeypatch):
    """kernels.LAUNCHED for the test alone: a fake wrapper must not reach
    another test's launch report."""
    monkeypatch.setattr(kernels, "LAUNCHED", {})
    return kernels.LAUNCHED


def _streams(monkeypatch, main):
    """Each thread's current stream handle: `main` on this thread, None
    (no stream) on the others until they set one; returns the thread-local."""
    streams = threading.local()
    streams.handle = main
    monkeypatch.setattr(kernels, "current_stream_handle",
                        lambda: getattr(streams, "handle", None))
    return streams


@pytest.mark.parametrize("replays", [1, 2, 5])
def test_replays_add_the_captured_counts(replays, launched, monkeypatch):
    _streams(monkeypatch, 0xA0)
    w = _fake_wrapper()
    with kernels.recording(0xA0) as record:
        kernels.count(w, b=2, s=64)
        kernels.count(w, b=2, s=64)
        kernels.count(w, b=1, s=16, also="launches_x2")
    assert (w.launches, w.shapes, w.launches_x2) == (0, {}, 0)  # a capture launches nothing
    for _ in range(replays):
        kernels.add_record(record)
    assert w.launches == 3 * replays
    assert w.shapes == {"b=2 s=64": 2 * replays, "b=1 s=16": replays}
    assert w.launches_x2 == replays
    assert launched == {w.__name__: w}


def test_recording_is_this_threads(launched, monkeypatch):
    """Another thread's launches during a capture, on another stream, are
    counted as launches."""
    _streams(monkeypatch, 0xA0)
    w = _fake_wrapper()
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait(10)
        for _ in range(100):
            kernels.count(w, b=1)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with kernels.recording(0xA0) as record:
        inside.set()
        assert done.wait(10)
        kernels.count(w, b=7)
    t.join(10)
    assert not t.is_alive()
    assert w.shapes == {"b=1": 100}
    assert record == {w: {("b=7", None): 1}}


# ------------------------------------------------------------ (d) the switch

def test_graphs_on_cpu_raise():
    with pytest.raises(ValueError, match="CUDA"):
        StableDiffusion(PARAMS, SD_TINY, graphs=True)
    sd = StableDiffusion(PARAMS, SD_TINY)
    assert sd.graphs is False and sd.graph_cache is None
    with pytest.raises(ValueError, match="CUDA"):
        sd.with_graphs(True)
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GraphCache("cpu")
    with pytest.raises(ValueError, match="graphs on"):
        warm.capture(sd)


def test_warm_start_on_cpu_builds_the_runtime():
    ws = warm.WarmStart("cpu").start()
    ws.join(StableDiffusion(PARAMS, SD_TINY))
    labels = [label for label, _ in ws.timeline]
    assert labels == ["runtime_built", "joined"]
    assert ws.runtime_loaded in (True, False)


def test_warm_start_reraises_a_build_failure(monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed on planted.cu (1)")

    monkeypatch.setattr(kernels, "lib", broken)
    ws = warm.WarmStart(torch.device("cuda")).start()
    with pytest.raises(RuntimeError, match="planted"):
        ws.join()


# ------------------------------------------------------------ on the card

# sd-tiny at 256px with heads of 8: K2 and K4/K3 in the UNet at 64x64, K6,
# K7, K8 and K1 in the decoder
CARD_CFG = dataclasses.replace(SD_TINY, image_size=256,
                               unet=dataclasses.replace(SD_TINY.unet, n_head=2))
CARD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}


@pytest.fixture(scope="module")
def card_pair():
    """(graph pipeline, eager pipeline) over one f32 tree on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    params = _params("cuda", CARD_CFG)
    return (StableDiffusion(params, CARD_CFG, graphs=True),
            StableDiffusion(params, CARD_CFG, graphs=False))


def _card_inputs(name, seed=3):
    case = CASES[name]
    r = np.random.default_rng(seed)
    b, hw = case.get("b", 1), CARD_CFG.latent_size
    ctx = torch.from_numpy(r.standard_normal((b, 77, D)).astype(np.float32)).cuda()
    unctx = torch.from_numpy(r.standard_normal((1, 77, D)).astype(np.float32)).cuda()
    kw = {k: case[k] for k in ("sampler", "skip_steps", "karras_sigmas") if k in case}
    kw["ctx_valid"] = torch.arange(77, device="cuda")[None, :].expand(b, -1) < 7
    kw["uncond_valid"] = torch.arange(77, device="cuda")[None, :] < 2
    if case.get("initial"):
        kw["initial_latent"] = torch.from_numpy(
            r.standard_normal((b, hw, hw, 4)).astype(np.float32)).cuda()
    if case.get("inpaint"):
        kw["known_latent"] = torch.from_numpy(
            r.standard_normal((b, hw, hw, 4)).astype(np.float32)).cuda()
        mask = torch.zeros((b, hw, hw, 1), device="cuda")
        mask[:, 8:40, 4:30] = 1.0
        kw["known_mask"] = mask
    scale = torch.tensor([7.5, 3.0][:b], device="cuda") if case.get("per_item") else 7.5
    return (ctx, unctx, scale, STEPS), kw


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


CARD_CASES = [n for n in sorted(CASES) if CASES[n].get("pad", True)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_graph_matches_eager_on_card(name, card_pair):
    sd_g, sd_e = card_pair
    args, kw = _card_inputs(name)
    before = sd_g.graph_cache.replays["sample"]
    got = sd_g.sample_latent(*args, **kw, generator=_gen(4))
    want = sd_e.sample_latent(*args, **kw, generator=_gen(4))
    assert sd_g.graph_cache.replays["sample"] == before + 1
    assert float((got - want).abs().max()) <= CARD_TOL[torch.float32]


@pytest.mark.cuda
def test_stale_buffers_on_card(card_pair):
    """Two seeds, then two prompts, through one graph: each equals its own
    eager run."""
    sd_g, sd_e = card_pair
    args, kw = _card_inputs("euler_a")
    other_args, _ = _card_inputs("euler_a", seed=9)
    runs = [(args, 5), (args, 6), (other_args, 6), (args, 5)]
    got = [sd_g.sample_latent(*a, **kw, generator=_gen(s)) for a, s in runs]
    for (a, s), g in zip(runs, got):
        want = sd_e.sample_latent(*a, **kw, generator=_gen(s))
        assert float((g - want).abs().max()) <= CARD_TOL[torch.float32]
    assert float((got[0] - got[1]).abs().max()) > 0.01


@pytest.mark.cuda
def test_two_graphs_in_turns_on_card(card_pair):
    sd_g, sd_e = card_pair
    runs = [_card_inputs(n) for n in ("ddim", "inpaint_euler_a", "ddim", "inpaint_euler_a")]
    for i, (args, kw) in enumerate(runs):
        got = sd_g.sample_latent(*args, **kw, generator=_gen(i))
        want = sd_e.sample_latent(*args, **kw, generator=_gen(i))
        assert float((got - want).abs().max()) <= CARD_TOL[torch.float32]


@pytest.mark.cuda
def test_decode_clip_encode_on_card(card_pair):
    sd_g, sd_e = card_pair
    r = np.random.default_rng(1)
    hw = CARD_CFG.latent_size
    lat = torch.from_numpy(r.standard_normal((1, hw, hw, 4)).astype(np.float32)).cuda()
    for _ in range(2):
        got, want = sd_g._decode_u8(lat), sd_e._decode_u8(lat)
        assert (got.int() - want.int()).abs().max() <= 1
    ids = [49406, 320, 1125, 49407]
    (gc, gv), (ec, ev) = sd_g.encode_ids(ids), sd_e.encode_ids(ids)
    assert torch.equal(gv, ev) and float((gc - ec).abs().max()) <= CARD_TOL[torch.float32]
    img = r.uniform(-1, 1, (1, CARD_CFG.image_size, CARD_CFG.image_size, 3)).astype(np.float32)
    got, want = sd_g.encode_image(img), sd_e.encode_image(img)
    assert float((got - want).abs().max()) <= CARD_TOL[torch.float32]
    assert {"decode", "clip", "encode"} <= set(sd_g.graph_cache.captures)


@pytest.mark.cuda
def test_replay_counts_on_card(card_pair):
    """N replays count N times an eager call's launches, per shape."""
    sd_g, sd_e = card_pair
    args, kw = _card_inputs("ddim")
    fns = {}

    def read_and_zero():
        torch.cuda.synchronize()
        out = {n: dict(f.shapes) for n, f in kernels.LAUNCHED.items()}
        for f in kernels.LAUNCHED.values():
            f.launches, f.shapes = 0, {}
        fns.update(kernels.LAUNCHED)
        return {n: s for n, s in out.items() if s}

    sd_g.latent_to_image(sd_g.sample_latent(*args, **kw, generator=_gen(0)))  # captured
    read_and_zero()
    sd_e.latent_to_image(sd_e.sample_latent(*args, **kw, generator=_gen(0)))
    eager = read_and_zero()
    assert eager, "no kernel launched: the card config opens no gate"
    for _ in range(3):
        sd_g.latent_to_image(sd_g.sample_latent(*args, **kw, generator=_gen(0)))
    replayed = read_and_zero()
    assert replayed == {n: {k: 3 * v for k, v in s.items()} for n, s in eager.items()}
