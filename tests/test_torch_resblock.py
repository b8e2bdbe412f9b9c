"""The port's whole-ResnetBlock (kernel B.4) and the UNet's opt-in kernels against the JAX package.

On the CPU the port's wrapper runs its plain version,
``resnet_block_reference``, which is held here against the Pallas kernel
in interpret mode (``fused_resnet_block_interpret``) on the same numpy
inputs: fp32 at 2e-5 (KERNELS.json's fp32 forward tolerance), bf16 at 3e-2
(the bound tests/test_pallas_resblock.py uses: both round the conv1 output
to bf16 before conv2 and the sum once), and the VJP in x and all twelve
parameters against ``jax.vjp`` of the interpret path (JAX's
``_block_bwd``) at 2e-4 of each gradient's largest entry. JAX's layout is
NHWC with HWIO weights, the port's NCHW with OIHW weights.

The CUDA kernel itself runs only on the card (``chip_smoke.py``); what
surrounds it is held here: its tensor-core weight layout, read by the
addresses the kernel's wgmma descriptors give, in an im2col GEMM against
``F.conv2d``; the layout cache; and its fp32 route, split TF32, emulated
in plain PyTorch against the 2e-5 gate, with one TF32 product as the
control that must miss it.

Then the UNet (dim 16): with ``fused_resblock`` it keeps the default
``state_dict`` keys; its routing sends 19 blocks through B.4 and none
through B.3 when both flags are set; each flag against the JAX
``Unet(use_pallas_*=True)`` (on the CPU its jnp references) at 2e-4 in
fp32 and 3e-2 of the largest entry in bf16; and the slice: a folded TEDM
prediction served by ``Predictor`` from a ``--use_pallas_resblock
--use_pallas_flash --mixed_precision`` checkpoint against the JAX pipeline
from the same weights (``utils/convert.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tedm_tpu.models.segmentation import PixelClassifier as JaxPixelClassifier
from tedm_tpu.models.segmentation import extract_features as jax_extract_features
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.ops.pallas.resblock import fused_resnet_block_interpret as jax_interpret
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu.utils.torch_port import convert_unet_state_dict
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.kernels import resblock as RB
from tedm_tpu_torch.models import unet as U
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.utils.checkpoint import save_checkpoint
from tedm_tpu_torch.utils.convert import classifier_state_dict

torch.set_num_threads(1)

NAMES = ("x", "w1", "b1", "g1", "be1", "scale", "shift", "w2", "b2", "g2", "be2", "wres", "bres")


def _inputs(b, cin, cout, h, w, seed=0):
    """JAX-layout inputs: x NHWC, w1 and w2 HWIO, wres (Cin, Cout) or None."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    res = cin != cout
    return dict(
        x=f(b, h, w, cin), w1=f(3, 3, cin, cout) * (9 * cin) ** -0.5, b1=0.1 * f(cout), g1=1 + 0.1 * f(cout),
        be1=0.1 * f(cout), scale=0.5 * f(b, cout), shift=0.5 * f(b, cout),
        w2=f(3, 3, cout, cout) * (9 * cout) ** -0.5, b2=0.1 * f(cout), g2=1 + 0.1 * f(cout), be2=0.1 * f(cout),
        wres=f(cin, cout) * cin ** -0.5 if res else None, bres=0.1 * f(cout) if res else None,
    )


def _port(inp, film=True, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    out = {k: t(v) for k, v in inp.items()}
    out["x"] = t(inp["x"].transpose(0, 3, 1, 2)).to(dtype)
    out["w1"], out["w2"] = (t(inp[k].transpose(3, 2, 0, 1)) for k in ("w1", "w2"))
    if inp["wres"] is not None:
        out["wres"] = t(inp["wres"].T[:, :, None, None])
    if not film:
        out["scale"] = out["shift"] = None
    return [out[k] for k in NAMES]


def _jax(inp, film=True, dtype=jnp.float32):
    j = [None if inp[k] is None else jnp.asarray(inp[k]) for k in NAMES]
    j[0] = j[0].astype(dtype)
    if not film:
        j[5] = j[6] = None
    return j


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("cin,cout,h,w,film", [
    (16, 16, 6, 10, True), (16, 24, 8, 8, True), (24, 16, 5, 7, False), (16, 16, 1, 1, True),
])
def test_plain_version_matches_jax_in_fp32(cin, cout, h, w, film):
    inp = _inputs(2, cin, cout, h, w)
    got = RB.fused_resnet_block(*_port(inp, film))  # CPU: the plain version
    want = np.asarray(jax_interpret(*_jax(inp, film)))
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("cin,cout", [(16, 16), (16, 24)])
def test_plain_version_matches_jax_in_bf16(cin, cout):
    inp = _inputs(2, cin, cout, 8, 12, seed=1)
    got = RB.fused_resnet_block(*_port(inp, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_interpret(*_jax(inp, dtype=jnp.bfloat16)).astype(jnp.float32))
    assert np.abs(_nhwc(got) - want).max() <= 3e-2


def test_vjp_matches_jax():
    cout = 24
    inp = _inputs(2, 16, cout, 4, 6, seed=2)
    g = np.random.RandomState(3).randn(2, 4, 6, cout).astype(np.float32)
    jargs = _jax(inp)
    live = [i for i, a in enumerate(jargs) if a is not None]

    def fn(*a):
        full = list(jargs)
        for i, v in zip(live, a):
            full[i] = v
        return jax_interpret(*full)

    _, vjp = jax.vjp(fn, *(jargs[i] for i in live))
    want = vjp(jnp.asarray(g))
    leaves = [None if t is None else t.requires_grad_() for t in _port(inp)]
    RB.fused_resnet_block(*leaves).backward(torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2))))
    to_jax = {"x": _nhwc, "w1": lambda t: t.numpy().transpose(2, 3, 1, 0), "w2": lambda t: t.numpy().transpose(2, 3, 1, 0),
              "wres": lambda t: t.numpy()[:, :, 0, 0].T}
    for i, w in zip(live, want):
        name, grad = NAMES[i], leaves[i].grad
        got = to_jax.get(name, lambda t: t.numpy())(grad)
        w = np.asarray(w)
        assert got.shape == w.shape and np.abs(w).max() > 0, name
        assert np.abs(got - w).max() <= 2e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 5e-2)])
def test_conv2_padding_control_is_visible(dtype, tol):
    """The card check's likeliest-bug control, conv2 padding h with
    SiLU(GN1(0)) instead of 0 after the normalising prologue, moves the
    border pixels far beyond the gate, and them most (the interior moves
    only through GN2's statistics)."""
    args = _port(_inputs(2, 16, 16, 8, 12, seed=4), dtype=dtype)
    diff = (RB.resnet_block_reference(*args).float() - RB.resnet_block_reference(*args, pad_after_norm=True).float()).abs()
    assert diff.max() > 10 * tol
    interior = diff[:, :, 1:-1, 1:-1].max()
    diff[:, :, 1:-1, 1:-1] = 0
    assert diff.max() > 2 * interior


def test_cpu_tensors_take_the_plain_version():
    args = _port(_inputs(1, 16, 24, 4, 4, seed=5), dtype=torch.bfloat16)
    before = RB.fused_resnet_block.launches
    out = RB.fused_resnet_block(*args)
    assert RB.fused_resnet_block.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, RB.resnet_block_reference(*args), atol=0, rtol=0)


def _as_the_kernel_reads(layout, cout, cin, taps, cdt):
    """Decode a tensor-core weight layout by the addresses conv_tc's wgmma
    descriptors give (csrc/tensor_core.cuh: a core matrix is 8 rows of 16
    bytes, LBO = 128 bytes to the next along K, SBO = 256 bytes to the next
    8 rows of N; one k-step 2048 bytes; per 64-channel block and chunk of
    KC input channels, [plane][tap][k-step]): (planes, Cout, Cin, taps)."""
    esize = layout.element_size()
    e, kc = 16 // esize, {torch.bfloat16: 32, torch.float32: 8}[cdt]
    ksteps, planes = kc // (2 * e), 1 if cdt == torch.bfloat16 else 2
    nb, nc = -(-cout // 64), -(-cin // kc)
    flat = layout.reshape(-1)
    assert flat.numel() * esize == nb * nc * planes * taps * ksteps * 2048
    out = torch.zeros(planes, nb * 64, nc * kc, taps, dtype=layout.dtype)
    n, kk = torch.meshgrid(torch.arange(64), torch.arange(2 * e), indexing="ij")
    for b in range(nb):
        for c in range(nc):
            for p in range(planes):
                for tap in range(taps):
                    for ks in range(ksteps):
                        start = (((b * nc + c) * planes + p) * taps * ksteps + tap * ksteps + ks) * 2048
                        byte = start + (n // 8) * 256 + (kk // e) * 128 + (n % 8) * 16 + (kk % e) * esize
                        out[p, b * 64 + n, c * kc + ks * 2 * e + kk, tap] = flat[byte // esize]
    return out[:, :cout, :cin]


def test_taps_layout():
    """The kernel's weight layout (tc_weight_layout), read as the kernel
    reads it, in an im2col GEMM in plain PyTorch: it reproduces F.conv2d to
    1e-6 in fp32 (the TF32 hi and lo planes summed) and bit for bit on
    bf16 values (integers, so that every sum is exact in any order); with
    Cout and Cin off the 64-channel blocks and chunks, and a 1x1 conv."""
    for cdt in (torch.float32, torch.bfloat16):
        for cout, cin, k in [(24, 16, 3), (64, 40, 3), (72, 24, 1)]:
            _check_layout(cdt, cout, cin, k)


def _check_layout(cdt, cout, cin, k):
    rs = np.random.RandomState(cout + cin + k)
    if cdt == torch.bfloat16:
        w = torch.from_numpy(rs.randint(-8, 9, (cout, cin, k, k)).astype(np.float32))
        x = torch.from_numpy(rs.randint(-8, 9, (2, cin, 5, 7)).astype(np.float32))
    else:
        w = torch.from_numpy(rs.randn(cout, cin, k, k).astype(np.float32))
        x = torch.from_numpy(rs.randn(2, cin, 5, 7).astype(np.float32))
    layout = RB.tc_weight_layout(w, cdt)
    assert layout.dtype == cdt and layout.is_contiguous()
    read = _as_the_kernel_reads(layout, cout, cin, k * k, cdt).float()
    if cdt == torch.float32:
        hi, lo = read
        assert torch.equal(hi, RB.tf32_round(hi)) and torch.equal(lo, RB.tf32_round(lo))
        torch.testing.assert_close(hi + lo, w.reshape(cout, cin, k * k), atol=0, rtol=2 ** -21)
    wmat = read.sum(0).reshape(cout, cin * k * k)
    cols = F.unfold(x, k, padding=k // 2)  # (B, Cin * taps, pixels), channel-major as wmat
    got = (wmat @ cols).reshape(2, cout, 5, 7)
    want = F.conv2d(x, w, padding=k // 2)
    if cdt == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


def test_weight_layout_is_cached_per_version():
    """A layout is built once per weight and dtype and reused; an in-place
    update of the weight (an optimizer step) rebuilds it on the next call."""
    w = torch.nn.Parameter(torch.randn(24, 16, 3, 3))
    built = RB.fused_resnet_block.layouts_built
    first = RB.cached_weight_layout(w, torch.bfloat16)
    assert RB.cached_weight_layout(w, torch.bfloat16) is first
    assert RB.fused_resnet_block.layouts_built == built + 1
    other = RB.cached_weight_layout(w, torch.float32)  # another dtype, another layout
    assert other.dtype == torch.float32 and RB.fused_resnet_block.layouts_built == built + 2
    with torch.no_grad():
        w.mul_(2)
    second = RB.cached_weight_layout(w, torch.bfloat16)
    assert second is not first and RB.fused_resnet_block.layouts_built == built + 3
    assert torch.equal(second.float(), 2 * first.float())
    key = (id(w), torch.bfloat16)
    del w
    assert key not in RB._layouts  # dropped with the weight


def test_weight_layout_is_rebuilt_when_the_storage_moves():
    """``w.data = t`` (as ``Module.to`` and weight swaps do) keeps the
    tensor and its version but not its storage: the next call lays out t."""
    w = torch.nn.Parameter(torch.randn(24, 16, 3, 3))
    first = RB.cached_weight_layout(w, torch.bfloat16)
    version = w._version
    w.data = 3 * w.data
    assert w._version == version
    built = RB.fused_resnet_block.layouts_built
    second = RB.cached_weight_layout(w, torch.bfloat16)
    assert RB.fused_resnet_block.layouts_built == built + 1
    assert torch.equal(second, RB.tc_weight_layout(w, torch.bfloat16)) and not torch.equal(second, first)
    assert RB.cached_weight_layout(w, torch.bfloat16) is second


def _split_conv(single_pass):
    """F.conv2d as the kernel's fp32 route computes it: split TF32,
    lo*hi + hi*lo + hi*hi summed in fp32; or one TF32 product (a control)."""
    def conv2d(x, w, padding=0):
        (xh, xl), (wh, wl) = RB.tf32_split(x), RB.tf32_split(w)
        if single_pass:
            return F.conv2d(xh, wh, padding=padding)
        return F.conv2d(xl, wh, padding=padding) + F.conv2d(xh, wl, padding=padding) + F.conv2d(xh, wh, padding=padding)
    return types.SimpleNamespace(conv2d=conv2d, pad=F.pad)


def test_split_tf32_holds_the_fp32_gate_at_512_channels(monkeypatch):
    """The block at 512 channels (3x3 sums 4608 deep) through split-TF32
    convolutions agrees with the fp32 plain version within the 2e-5 gate;
    the same block with one TF32 product a product (the control) does not."""
    args = _port(_inputs(2, 512, 512, 8, 8, seed=6))
    args[0] = 0.2 * args[0]  # x at the card check's scale
    want = RB.resnet_block_reference(*args)
    errs = {}
    for single in (False, True):
        monkeypatch.setattr(RB, "F", _split_conv(single))
        errs[single] = (RB.resnet_block_reference(*args) - want).abs().max().item()
    assert errs[False] <= 2e-5 < errs[True], errs


def test_bf16_operands_need_two_products():
    """bf16 values are exact in TF32: their lo part is 0, so a product with
    a bf16 operand needs two TF32 products (hi*hi + lo*hi), not three."""
    x = torch.randn(4096).bfloat16().float()
    hi, lo = RB.tf32_split(x)
    assert torch.equal(hi, x) and not lo.any()
    y = torch.randn(4096)
    (yh, yl) = RB.tf32_split(y)
    assert torch.equal(yl * hi + yh * lo + yh * hi, yl * hi + yh * hi)


def test_unet_fused_resblock_keeps_the_state_dict():
    default = U.Unet(dim=16, dim_mults=(1, 2))
    for kw in ({"fused_resblock": True}, {"fused_groupnorm": True, "flash_attention": True}):
        fused = U.Unet(dim=16, dim_mults=(1, 2), **kw)
        assert {k: v.shape for k, v in fused.state_dict().items()} == {k: v.shape for k, v in default.state_dict().items()}
        fused.load_state_dict(default.state_dict())


@pytest.mark.parametrize("flags,calls", [
    ({"fused_groupnorm": True}, {"gn": 38, "rb": 0, "fa": 0}),
    ({"fused_resblock": True, "flash_attention": True}, {"gn": 0, "rb": 19, "fa": 1}),
    ({"fused_groupnorm": True, "fused_resblock": True}, {"gn": 0, "rb": 19, "fa": 0}),
])
def test_unet_routes_each_flag_to_its_kernel(flags, calls, monkeypatch):
    """At the default depth a forward makes 38 GroupNorm calls (two per
    ResnetBlock), 19 ResnetBlock calls and 1 mid attention; with both block
    flags the ResnetBlock kernel wins and no GroupNorm kernel runs."""
    seen = dict.fromkeys(calls, 0)
    for key, name in (("gn", "fused_group_norm_film_silu"), ("rb", "fused_resnet_block"), ("fa", "flash_cosine_attention")):
        fn = getattr(U, name)

        def counted(*a, _fn=fn, _key=key, **k):
            seen[_key] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(U, name, counted)
    unet = U.Unet(dim=16, dim_mults=(1, 2, 4, 8), **flags).eval()
    with torch.no_grad():
        unet(torch.randn(1, 1, 32, 32), torch.tensor([5]))
    assert seen == calls


JAX_FLAGS = {"fused_groupnorm": "use_pallas_groupnorm", "fused_resblock": "use_pallas_resblock",
             "flash_attention": "use_pallas_flash"}


@pytest.fixture(scope="module")
def weights():
    """A dim-16, mults-(1, 2) UNet's weights, torch's init perturbed so that
    no bias or gain keeps its trivial value: a port state_dict and the same
    numbers as JAX params (tedm_tpu/utils/torch_port.py)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        sd = U.Unet(dim=16, dim_mults=(1, 2)).state_dict()
    rs = np.random.RandomState(0)
    sd = {k: v + 0.1 * torch.from_numpy(rs.randn(*v.shape).astype(np.float32)) for k, v in sd.items()}
    return sd, convert_unet_state_dict(sd, n_stages=2)


@pytest.mark.parametrize("flags,dtype", [
    (("fused_groupnorm", "flash_attention"), torch.float32),
    (("fused_groupnorm", "flash_attention"), torch.bfloat16),
    (("fused_resblock", "flash_attention"), torch.float32),
    (("fused_resblock", "flash_attention"), torch.bfloat16),
])
def test_unet_with_the_flags_matches_jax(flags, dtype, weights):
    sd, params = weights
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jmodel = JaxUnet(dim=16, dim_mults=(1, 2), channels=1, dtype=jdt, use_pallas=True,
                     **{JAX_FLAGS[f]: True for f in flags})
    unet = U.Unet(dim=16, dim_mults=(1, 2), dtype=dtype, **{f: True for f in flags}).eval()
    unet.load_state_dict(sd)
    x = np.random.RandomState(1).randn(2, 32, 32, 1).astype(np.float32)
    t = np.array([3, 777])
    out_j, feats_j = jax.jit(lambda p, x, t: jmodel.apply(p, x, t, extract_features=True))(
        {"params": params}, jnp.asarray(x), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        out, feats = unet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t), extract_features=True)
    assert out.dtype == dtype
    for got, want in [(out, out_j)] + list(zip(feats, feats_j)):
        got, want = _nhwc(got), np.asarray(want.astype(jnp.float32))
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        else:
            assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_bf16_tedm_prediction_with_resblock_and_flash_matches_jax(weights, tmp_path):
    """The slice as a whole: a checkpoint whose config.json sets
    ``use_pallas_resblock``, ``use_pallas_flash`` and ``mixed_precision`` is
    served by ``Predictor`` with the two kernels' paths in bf16, and its
    ensembled probabilities match the JAX pipeline's to 2e-2 (bf16 features
    of two frameworks through an fp32 head; measured 4e-3)."""
    dim, mults, size = 16, (1, 2), 32
    cfg = Config(log_dir=str(tmp_path / "run")).replace(
        experiment="TEDM", n_labelled_images=1, dim=dim, dim_mults=mults, img_size=size,
        saved_diffusion_model=str(tmp_path / "no_backbone"), mixed_precision=True,
        use_pallas_resblock=True, use_pallas_flash=True,
    ).apply_experiment_preset()
    rs = np.random.RandomState(0)
    img = rs.rand(1, size, size, 1).astype(np.float32)
    noise = rs.randn(1, size, size, 1).astype(np.float32)
    jmodel = JaxUnet(dim=dim, dim_mults=mults, channels=1, dtype=jnp.bfloat16, use_pallas=True,
                     use_pallas_resblock=True, use_pallas_flash=True)
    perturb = lambda tree: jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.1 * rs.randn(*p.shape).astype(np.float32), tree)
    sd, uparams = weights
    feats = jax.jit(lambda p, x, n: jax_extract_features(
        lambda xx, tt, **kw: jmodel.apply({"params": p}, xx, tt, **kw),
        jax_make_schedule(cfg.timesteps, cfg.beta_schedule), x, cfg.t_steps_to_save, noise=n,
    ))(uparams, jnp.asarray(img), jnp.asarray(noise))
    jclf = JaxPixelClassifier(stage_channels=(32, 16), n_steps=1, img_size=size)
    cvars = jclf.init(jax.random.PRNGKey(1), feats, train=False)
    cparams = perturb(cvars["params"])
    stats = {k: {"mean": np.zeros_like(v["mean"]), "var": np.ones_like(v["var"])} for k, v in cvars["batch_stats"].items()}
    logits = jclf.apply({"params": cparams, "batch_stats": stats}, feats, train=False)
    want = np.asarray(jax.nn.sigmoid(logits.astype(jnp.float32))).reshape(len(cfg.t_steps_to_save), 1, size, size, 1).mean(axis=0)

    as_tensors = lambda sd: {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    save_checkpoint(str(tmp_path / "logs" / "TEDM" / "1" / "best"),
                    {"backbone": sd,
                     "classifier": as_tensors(classifier_state_dict(cparams, stats, shared=True))}, cfg)
    pred = Predictor(logs_root=str(tmp_path / "logs"), device="cpu")
    got = pred._probabilities(img, "TEDM", 1, noise=noise)
    unet = next(iter(pred._cache.values()))[1].unet
    assert unet.compute_dtype == torch.bfloat16 and unet.mid_block1.fused and unet.mid_attn.fn.fn.flash
    assert not unet.mid_block1.block1.norm.fused
    assert 0.05 < want.std()  # probabilities not saturated: the comparison has teeth
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 2e-2
