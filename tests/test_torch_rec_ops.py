"""Port parity of the recurrent mixers and their scans against the JAX
functions on the CPU, on the same inputs made from a seed (f32): the
causal conv, mamba's `_mixer` (plain, falcon-mamba's dt/B/C norms,
jamba's learned ones), `_mixer2` (grouped B/C, with and without the gated
norm), lfm2's `_mixer_shortconv`, qwen3-next's `_mixer_deltanet`, and
rwkv's `_rwkv6_time_mix`, `_rwkv6_channel_mix` and `_rwkv7_time_mix` (T 4
and 24: both sides of the JAX rwkv7 switch at T = 8); and the plain
versions of ops/ssm_scan and ops/wkv against JAX's scans directly.

Every case enters with non-zero states and three slots of seq_lens 0, a
part of T and T: the outputs of the valid rows agree within 1e-4 x
max|JAX| (f32 sums in another order), the states within 1e-5 x max|JAX|
+ 1e-6, and the slot with seq_lens 0 keeps its entering state bit for
bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_box_tpu.models import mamba as jm
from llama_box_tpu.models import rwkv as jr
from llama_box_tpu.models.config import ModelConfig as JCfg
from llama_box_tpu_torch.models import mamba as tm
from llama_box_tpu_torch.models import rwkv as tr
from llama_box_tpu_torch.models.config import ModelConfig as TCfg
from llama_box_tpu_torch.ops import ssm_scan as tss
from llama_box_tpu_torch.ops import wkv as twkv

S, E = 3, 32


def _rng(seed):
    return np.random.default_rng(seed)


def _r(rng, *shape, s=0.3):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _lens(T):
    return np.array([0, max(1, T // 2 - 1), T], np.int32)


def _both(lp):
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v.copy()) for k, v in lp.items()})


def _cfgs(**kw):
    j = JCfg(arch=kw.pop("arch", "mamba"), n_embd=E, rms_eps=1e-5, **kw)
    return j, TCfg(**dataclasses.asdict(j))


def _close(got, want, rel, what, rows=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if rows is not None:
        got, want = got[rows], want[rows]
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + (1e-6 if rel < 1e-4 else 0.0), \
        (what, err, scale)


def _check_out(tout, jout, lens):
    """The valid rows of each slot (the other rows read the frozen state
    in both, and may differ by the sum order alone)."""
    for b, n in enumerate(lens):
        if n:
            _close(tout[b, :n].detach().numpy(), np.asarray(jout[b, :n]),
                   1e-4, f"slot {b} out")


def _check_state(t_new, j_new, t_old):
    _close(t_new.numpy(), np.asarray(j_new), 1e-5, "state")
    assert torch.equal(t_new[0], t_old[0]), "a seq_lens 0 slot moved"


@pytest.mark.parametrize("T", [4, 24])
def test_causal_conv_matches_jax(T):
    rng = _rng(1)
    C, dc = 8, 4
    conv0, xc = _r(rng, S, dc - 1, C), _r(rng, S, T, C)
    w, b = _r(rng, C, dc), _r(rng, C)
    lens = _lens(T)
    jout, jtail = jm._causal_conv(jnp.asarray(conv0), jnp.asarray(xc),
                                  jnp.asarray(w), jnp.asarray(b),
                                  jnp.asarray(lens))
    tc = torch.from_numpy(conv0.copy())
    old = tc.clone()
    tout = tm._causal_conv(tc, torch.from_numpy(xc), torch.from_numpy(w),
                           torch.from_numpy(b), torch.from_numpy(lens))
    _close(tout.numpy(), np.asarray(jout), 1e-6, "conv out")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jtail))
    assert torch.equal(tc[0], old[0])


def _mamba1_lp(rng, di, ds, dtr, dc, norms):
    lp = {"ssm_in": _r(rng, E, 2 * di), "ssm_conv_w": _r(rng, di, dc),
          "ssm_conv_b": _r(rng, di), "ssm_x": _r(rng, di, dtr + 2 * ds),
          "ssm_dt": _r(rng, dtr, di), "ssm_dt_b": _r(rng, di),
          "ssm_a": -np.exp(_r(rng, di, ds)).astype(np.float32),
          "ssm_d": 1 + _r(rng, di, s=0.1), "ssm_out": _r(rng, di, E)}
    if norms:
        lp.update(ssm_dt_norm=1 + _r(rng, dtr, s=0.1),
                  ssm_b_norm=1 + _r(rng, ds, s=0.1),
                  ssm_c_norm=1 + _r(rng, ds, s=0.1))
    return lp


def _run_mixer(jfn, tfn, jlp, tlp, jcfg, tcfg, conv0, ssm0, x, lens):
    jout, jconv, jssm = jfn(jlp, jnp.asarray(x), jnp.asarray(conv0),
                            jnp.asarray(ssm0), jnp.asarray(lens), jcfg)
    tconv = torch.from_numpy(conv0.copy())
    tssm = torch.from_numpy(ssm0.copy())
    old_c, old_s = tconv.clone(), tssm.clone()
    tout = tfn(tlp, torch.from_numpy(x), tconv, tssm,
               torch.from_numpy(lens), tcfg)
    _check_out(tout, jout, lens)
    _check_state(tconv, jconv, old_c)
    _check_state(tssm, jssm, old_s)


@pytest.mark.parametrize("variant", ["plain", "falcon_mamba", "jamba"])
@pytest.mark.parametrize("T", [4, 24])
def test_mixer_matches_jax(variant, T):
    rng = _rng(2)
    di, ds, dtr, dc = 16, 8, 4, 4
    jcfg, tcfg = _cfgs(ssm_d_inner=di, ssm_d_state=ds, ssm_dt_rank=dtr,
                       ssm_d_conv=dc,
                       ssm_dt_b_c_rms=variant == "falcon_mamba")
    jlp, tlp = _both(_mamba1_lp(rng, di, ds, dtr, dc, variant == "jamba"))
    _run_mixer(jm._mixer, tm._mixer, jlp, tlp, jcfg, tcfg,
               _r(rng, S, dc - 1, di), _r(rng, S, di, ds, s=0.5),
               _r(rng, S, T, E, s=1.0), _lens(T))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("T", [4, 24])
def test_mixer2_matches_jax(gated, T):
    rng = _rng(3)
    nh, hd, ds, ng, dc = 4, 8, 16, 2, 4
    di = nh * hd
    conv_dim = di + 2 * ng * ds
    jcfg, tcfg = _cfgs(arch="mamba2", ssm_d_inner=di, ssm_d_state=ds,
                       ssm_dt_rank=nh, ssm_n_group=ng, ssm_d_conv=dc)
    lp = {"ssm_in": _r(rng, E, 2 * di + 2 * ng * ds + nh),
          "ssm_conv_w": _r(rng, conv_dim, dc), "ssm_conv_b": _r(rng, conv_dim),
          "ssm_dt_b": _r(rng, nh), "ssm_a": -np.exp(_r(rng, nh)),
          "ssm_d": 1 + _r(rng, nh, s=0.1), "ssm_out": _r(rng, di, E)}
    lp["ssm_a"] = lp["ssm_a"].astype(np.float32)
    if gated:
        lp["ssm_norm"] = 1 + _r(rng, di, s=0.1)
    jlp, tlp = _both(lp)
    _run_mixer(jm._mixer2, tm._mixer2, jlp, tlp, jcfg, tcfg,
               _r(rng, S, dc - 1, conv_dim), _r(rng, S, nh, hd, ds, s=0.5),
               _r(rng, S, T, E, s=1.0), _lens(T))


@pytest.mark.parametrize("T", [4, 24])
def test_mixer_shortconv_matches_jax(T):
    rng = _rng(4)
    dc = 3
    jcfg, tcfg = _cfgs(arch="lfm2", shortconv_l_cache=dc)
    jlp, tlp = _both({"shortconv_in": _r(rng, E, 3 * E),
                      "shortconv_conv": _r(rng, E, dc),
                      "shortconv_out": _r(rng, E, E)})
    _run_mixer(jm._mixer_shortconv, tm._mixer_shortconv, jlp, tlp, jcfg,
               tcfg, _r(rng, S, dc - 1, E), np.zeros((S, 1, 1), np.float32),
               _r(rng, S, T, E, s=1.0), _lens(T))


@pytest.mark.parametrize("T", [4, 24])
def test_mixer_deltanet_matches_jax(T):
    rng = _rng(5)
    hk, nh, Dk, Dv, dc = 2, 4, 16, 16, 4
    R = nh // hk
    conv_dim = 2 * hk * Dk + nh * Dv
    jcfg, tcfg = _cfgs(arch="qwen3next", ssm_d_state=Dk, ssm_d_conv=dc)
    jlp, tlp = _both({
        "ssm_in": _r(rng, E, hk * (2 * Dk + 2 * R * Dv)),
        "ssm_ba": _r(rng, E, hk * 2 * R), "ssm_conv_w": _r(rng, conv_dim, dc),
        "ssm_a": -np.exp(_r(rng, nh)).astype(np.float32),
        "ssm_dt_b": _r(rng, nh), "ssm_norm": 1 + _r(rng, Dv, s=0.1),
        "ssm_out": _r(rng, nh * Dv, E)})
    _run_mixer(jm._mixer_deltanet, tm._mixer_deltanet, jlp, tlp, jcfg, tcfg,
               _r(rng, S, dc - 1, conv_dim), _r(rng, S, nh, Dk, Dv, s=0.5),
               _r(rng, S, T, E, s=1.0), _lens(T))


# -- rwkv ---------------------------------------------------------------------

HS = 8          # head size: H = 4 heads
EDIM, DDIM, FF = 4, 8, 64


def _rwkv6_lp(rng):
    return {"tm_lerp_x": 0.5 + _r(rng, E), "tm_lerp_fused": 0.5 + _r(rng, 5, 1, 1, E),
            "tm_w1": _r(rng, E, 5 * EDIM), "tm_w2": _r(rng, 5, EDIM, E),
            "tm_r": _r(rng, E, E), "tm_k": _r(rng, E, E),
            "tm_v": _r(rng, E, E), "tm_g": _r(rng, E, E),
            "tm_o": _r(rng, E, E), "tm_decay": _r(rng, E) - 1.0,
            "tm_decay_w1": _r(rng, E, DDIM), "tm_decay_w2": _r(rng, DDIM, E),
            "tm_first": _r(rng, E), "tm_ln": 1 + _r(rng, E, s=0.1),
            "tm_ln_b": _r(rng, E, s=0.1),
            "cm_lerp_k": 0.5 + _r(rng, E), "cm_lerp_r": 0.5 + _r(rng, E),
            "cm_k": _r(rng, E, FF), "cm_v": _r(rng, FF, E),
            "cm_r": _r(rng, E, E)}


def _rwkv7_lp(rng, first):
    lp = {"tm_lerp_fused": 0.5 + _r(rng, 6, 1, 1, E),
          "tm_r": _r(rng, E, E), "tm_k": _r(rng, E, E),
          "tm_v": _r(rng, E, E), "tm_o": _r(rng, E, E),
          "tm_w0": _r(rng, E) - 0.5, "tm_w1": _r(rng, E, DDIM),
          "tm_w2": _r(rng, DDIM, E), "tm_a0": _r(rng, E),
          "tm_a1": _r(rng, E, DDIM), "tm_a2": _r(rng, DDIM, E),
          "tm_g1": _r(rng, E, DDIM), "tm_g2": _r(rng, DDIM, E),
          "tm_kk": 1 + _r(rng, E, s=0.1), "tm_ka": _r(rng, E),
          "tm_rk": _r(rng, E), "tm_ln": 1 + _r(rng, E, s=0.1),
          "tm_ln_b": _r(rng, E, s=0.1)}
    if not first:
        lp.update(tm_v0=_r(rng, E), tm_v1=_r(rng, E, DDIM),
                  tm_v2=_r(rng, DDIM, E))
    return lp


def _shift_case(rng, T):
    return (_r(rng, S, T, E, s=1.0), _r(rng, S, E, s=1.0),
            _r(rng, S, E // HS, HS, HS, s=0.5), _lens(T))


@pytest.mark.parametrize("T", [4, 24])
def test_rwkv6_time_and_channel_mix_match_jax(T):
    rng = _rng(6)
    jcfg, tcfg = _cfgs(arch="rwkv6", wkv_head_size=HS)
    jlp, tlp = _both(_rwkv6_lp(rng))
    x, sh0, s0, lens = _shift_case(rng, T)
    jout, jsh, js = jr._rwkv6_time_mix(jlp, jnp.asarray(x), jnp.asarray(sh0),
                                       jnp.asarray(s0), jnp.asarray(lens),
                                       jcfg)
    tsh, ts = torch.from_numpy(sh0.copy()), torch.from_numpy(s0.copy())
    old_sh, old_s = tsh.clone(), ts.clone()
    tout = tr._rwkv6_time_mix(tlp, torch.from_numpy(x), tsh, ts,
                              torch.from_numpy(lens), tcfg)
    _check_out(tout, jout, lens)
    _check_state(tsh, jsh, old_sh)
    _check_state(ts, js, old_s)
    jout, jsh = jr._rwkv6_channel_mix(jlp, jnp.asarray(x), jnp.asarray(sh0),
                                      jnp.asarray(lens), jcfg)
    tsh = torch.from_numpy(sh0.copy())
    tout = tr._rwkv6_channel_mix(tlp, torch.from_numpy(x), tsh,
                                 torch.from_numpy(lens), tcfg)
    _check_out(tout, jout, lens)
    _check_state(tsh, jsh, old_sh)


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("T", [4, 24])
def test_rwkv7_time_mix_matches_jax(first, T):
    """T 4 takes JAX's per-token step, T 24 its chunked matrix scan; the
    port's one kernel serves both. Layer 0 (no v LoRA) sets v_first."""
    rng = _rng(7)
    jcfg, tcfg = _cfgs(arch="rwkv7", wkv_head_size=HS)
    jlp, tlp = _both(_rwkv7_lp(rng, first))
    x, sh0, s0, lens = _shift_case(rng, T)
    vf = _r(rng, S, T, E)
    jout, jsh, js, jvf = jr._rwkv7_time_mix(
        jlp, jnp.asarray(x), jnp.asarray(sh0), jnp.asarray(s0),
        jnp.asarray(vf), jnp.asarray(lens), jcfg)
    tsh, ts = torch.from_numpy(sh0.copy()), torch.from_numpy(s0.copy())
    old_sh, old_s = tsh.clone(), ts.clone()
    tout, tvf = tr._rwkv7_time_mix(tlp, torch.from_numpy(x), tsh, ts,
                                   torch.from_numpy(vf),
                                   torch.from_numpy(lens), tcfg)
    _check_out(tout, jout, lens)
    _check_out(tvf, jvf, lens)
    _check_state(tsh, jsh, old_sh)
    _check_state(ts, js, old_s)


# -- the scans alone -------------------------------------------------------------


def test_plain_ssm_scan_matches_jax_associative_scan():
    """ops/ssm_scan's plain version (mamba2 form: a decay a head, grouped
    B / C) against the JAX mixer's associative scan over the same dA and
    dBx."""
    rng = _rng(8)
    T, nh, hd, ds, G = 16, 4, 4, 8, 2
    C = nh * hd
    x, dt = _r(rng, S, T, C), np.abs(_r(rng, S, T, nh))
    A = -np.exp(_r(rng, nh)).astype(np.float32)
    B, Cm, D = _r(rng, S, T, G, ds), _r(rng, S, T, G, ds), _r(rng, nh)
    h0, lens = _r(rng, S, nh, hd, ds), _lens(T)
    rep = nh // G
    Bh, Ch = np.repeat(B, rep, 2), np.repeat(Cm, rep, 2)
    dA = np.exp(dt * A)[..., None, None] * np.ones((1, 1, 1, hd, ds))
    dBx = (dt[..., None] * x.reshape(S, T, nh, hd))[..., None] \
        * Bh[:, :, :, None, :]
    valid = (np.arange(T)[None, :] < lens[:, None])[..., None, None, None]
    dA = np.where(valid, dA, 1.0).astype(np.float32)
    dBx = np.where(valid, dBx, 0.0).astype(np.float32)
    dBx[:, 0] += dA[:, 0] * h0
    _, h = jm.jax.lax.associative_scan(jm._ssd_combine, (jnp.asarray(dA),
                                                         jnp.asarray(dBx)),
                                       axis=1)
    h = np.asarray(h)
    want = (h * Ch[:, :, :, None, :]).sum(-1) \
        + D[:, None] * x.reshape(S, T, nh, hd)
    state = torch.from_numpy(h0.copy())
    y = tss.ssm_scan(*(torch.from_numpy(a) for a in (x, dt, A, B, Cm, D,
                                                      lens)),
                     state.view(S, C, ds))
    _check_out(y.view(S, T, nh, hd), want, lens)
    _close(state.numpy(), h[:, -1], 1e-5, "state")


@pytest.mark.parametrize("T", [4, 24])
def test_plain_wkv_matches_jax_scans(T):
    """ops/wkv's plain rwkv6 and rwkv7 rules against JAX's _wkv6_scan and
    _wkv7_scan (chunked associative scans) on the same inputs."""
    rng = _rng(9)
    H, N = 2, 8
    r, k, v = (_r(rng, S, T, H, N) for _ in range(3))
    w = np.exp(-np.exp(_r(rng, S, T, H, N))).astype(np.float32)
    u, s0, lens = _r(rng, H, N), _r(rng, S, H, N, N), _lens(T)
    valid = np.arange(T)[None, :] < lens[:, None]
    a = k[..., :, None] * v[..., None, :]
    ok = valid[..., None, None, None]
    s_prev, s1 = jr._wkv6_scan(jnp.asarray(np.where(ok, w[..., None], 1.0)),
                               jnp.asarray(np.where(ok, a, 0.0)),
                               jnp.asarray(s0))
    want = np.einsum("sthi,sthij->sthj", r, np.asarray(s_prev)
                     + u[None, None, :, :, None] * np.where(ok, a, 0.0))
    st = torch.from_numpy(s0.copy())
    t_ = torch.from_numpy
    y = twkv.wkv6(t_(r), t_(k), t_(v), t_(w), t_(u), t_(lens), st)
    _check_out(y, want, lens)
    _close(st.numpy(), np.asarray(s1), 1e-5, "wkv6 state")

    kk = _r(rng, S, T, H, N)
    kk = kk / np.sqrt((kk * kk).sum(-1, keepdims=True) + 1e-12)
    aa = 1 / (1 + np.exp(-_r(rng, S, T, H, N)))
    s1, want = jr._wkv7_scan(*(jnp.asarray(z) for z in (r, w, k, v, kk, aa)),
                             jnp.asarray(valid), jnp.asarray(s0))
    st = torch.from_numpy(s0.copy())
    y = twkv.wkv7(t_(r), t_(w), t_(k), t_(v), t_(kk),
                  t_(aa.astype(np.float32)), t_(lens), st)
    _check_out(y, want, lens)
    _close(st.numpy(), np.asarray(s1), 1e-5, "wkv7 state")
