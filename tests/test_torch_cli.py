"""The port's command line (llama_box_tpu_torch/cli.py) against the JAX
CLI's: the compat group (llama-box flags accepted and ignored or mapped)
and the model overrides (rope, YaRN, attention type, --override-kv) parse
to the same values as the JAX parser gives, and set the config the JAX
CLI sets (llama_box_tpu/cli.py's main: the overrides applied to the
loaded config, --override-kv to the GGUF metadata before it is read)."""

import argparse
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from llama_box_tpu import cli as jcli
from llama_box_tpu.models import load_model as jax_load
from llama_box_tpu.models.loader import parse_kv_overrides as j_parse_kv
from llama_box_tpu_torch import cli
from llama_box_tpu_torch.models.loader import load_model, parse_kv_overrides
from .fixtures.make_tiny_model import write_tiny_model


def _compat_actions():
    jp = jcli.build_parser()
    return [a for g in jp._action_groups if g.title.startswith("compat")
            for a in g._group_actions]


def _argv_for(action) -> list:
    """A command line that sets `action` (a value both parsers take)."""
    flag = action.option_strings[0]
    if action.nargs == 0:
        return [flag]
    if action.choices:
        return [flag, sorted(action.choices)[-1]]
    return [flag, "3" if action.type in (int, float) else "x"]


@pytest.mark.parametrize("action", [
    a for a in _compat_actions()
    if a.dest != "device" and not isinstance(a, argparse._HelpAction)],
    ids=lambda a: a.option_strings[-1])
def test_compat_flags_parse_as_jax(action):
    """Every flag of the JAX compat group parses in the port (as each of
    its spellings) to the JAX value; unset, to the JAX default. The port
    keeps its own --device, so llama-box's -dev is a flag of its own."""
    p, jp = cli.build_parser(), jcli.build_parser()
    port_dest = "dev" if action.option_strings == ["-dev", "--device"] \
        else action.dest
    assert getattr(p.parse_args([]), port_dest) \
        == getattr(jp.parse_args([]), action.dest)
    for spelling in action.option_strings:
        if spelling == "--device":
            continue
        argv = [spelling] + _argv_for(action)[1:]
        assert getattr(p.parse_args(argv), port_dest) \
            == getattr(jp.parse_args(argv), action.dest), argv


OVERRIDES = [
    (["--rope-scaling", "yarn", "--rope-scale", "4", "--yarn-orig-ctx",
      "64", "--yarn-beta-fast", "16"],
     dict(rope_scaling_type="yarn", rope_freq_scale=0.25, rope_orig_ctx=64,
          yarn_beta_fast=16.0)),
    (["--rope-freq-base", "5e5", "--rope-freq-scale", "0.5",
      "--rope-scale", "4", "--yarn-ext-factor", "0.5",
      "--yarn-attn-factor", "1.5", "--yarn-beta-slow", "2"],
     dict(rope_freq_base=5e5, rope_freq_scale=0.5, yarn_ext_factor=0.5,
          yarn_attn_factor=1.5, yarn_beta_slow=2.0)),
    (["--attention", "non-causal"], dict(causal=False)),
    (["--rope-scaling", "linear", "--attention", "causal"],
     dict(rope_scaling_type="linear", causal=True)),
    ([], {}),
]


@pytest.mark.parametrize("argv,want", OVERRIDES)
def test_model_overrides_parse_and_set_the_jax_config(argv, want):
    """The parsed values equal the JAX parser's, and config_overrides
    gives the fields JAX cli.main sets from them (--rope-freq-scale wins
    over --rope-scale, which sets the scale to 1 / N)."""
    p, jp = cli.build_parser(), jcli.build_parser()
    a, ja = p.parse_args(argv), jp.parse_args(argv)
    for dest in ("rope_scaling", "rope_freq_base", "rope_freq_scale",
                 "yarn_orig_ctx", "rope_scale", "yarn_ext_factor",
                 "yarn_attn_factor", "yarn_beta_fast", "yarn_beta_slow",
                 "attention", "override_kv"):
        assert getattr(a, dest) == getattr(ja, dest), dest
    assert cli.config_overrides(a) == want


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "tiny.gguf")
    write_tiny_model(path)
    return path


def test_overrides_reach_the_served_config(model_path):
    """build_server applies --override-kv to the metadata before the
    config is read (as the JAX loader does) and the rope overrides after,
    so the engine serves the config the JAX CLI would."""
    kv = ["llama.rope.freq_base=float:20000", "llama.context_length=int:512"]
    argv = ["--rope-scaling", "linear", "--rope-scale", "2", "--attention",
            "causal", "-ngl", "99", "-fa", "-t", "2", "-b", "512", "--mlock"]
    engine, srv = cli.build_server(
        ["-m", model_path, "--device", "cpu", "--port", "0", "--no-jinja",
         "-np", "2", "-c", "128", "--weights-dtype", "f32"]
        + sum((["--override-kv", s] for s in kv), []) + argv)
    try:
        jcfg, _ = jax_load(model_path, dtype=jnp.float32,
                           metadata_overrides=j_parse_kv(kv))
        # the engine's load-time rope de-interleave makes the mode neox
        jcfg = dataclasses.replace(jcfg, rope_scaling_type="linear",
                                   rope_freq_scale=0.5, causal=True,
                                   rope_mode="neox")
        assert dataclasses.asdict(engine.cfg) == dataclasses.asdict(jcfg)
        assert engine.cfg.rope_freq_base == 20000.0
        assert engine.cfg.n_ctx_train == 512
    finally:
        srv.server_close()
        engine.stop()


def test_override_kv_parses_as_jax(model_path):
    specs = ["a=int:3", "b=float:0.5", "c=bool:true", "d=str:x"]
    assert parse_kv_overrides(specs) == j_parse_kv(specs)
    for bad in (["a=int"], ["a=list:1"], ["=int:1"]):
        with pytest.raises(ValueError):
            parse_kv_overrides(bad)
    cfg, _ = load_model(model_path, dtype=torch.float32, device="cpu",
                        metadata_overrides={"llama.rope.freq_base": 1e4 + 1})
    assert cfg.rope_freq_base == 1e4 + 1


# the JAX CLI's flags the port took last (JAX cli.py's model and completion
# groups): each parses to the JAX parser's value, unset to its default
MORE_FLAGS = [
    (["-s", "7"], "seed"), (["--seed", "7"], "seed"),
    (["-sp"], "special"), (["--special"], "special"),
    (["--chat-template-kwargs", '{"enable_thinking": false}'],
     "chat_template_kwargs"),
    (["--xtc-probability", "0.5"], "xtc_probability"),
    (["--xtc-threshold", "0.2"], "xtc_threshold"),
    (["--dynatemp-range", "0.3"], "dynatemp_range"),
    (["--dynatemp-exp", "1.5"], "dynatemp_exponent"),
    (["--top-nsigma", "2"], "top_nsigma"),
    (["--no-cache-prompt"], "prompt_cache"),
    (["-nr"], "no_repack"), (["--no-repack"], "no_repack"),
    (["--mmap"], "mmap"), (["--warmup"], "warmup"),
    (["--no-warmup"], "warmup"),
]


@pytest.mark.parametrize("argv,dest", MORE_FLAGS,
                         ids=[a[0] for a, _ in MORE_FLAGS])
def test_more_flags_parse_as_jax(argv, dest):
    p, jp = cli.build_parser(), jcli.build_parser()
    assert getattr(p.parse_args([]), dest) == getattr(jp.parse_args([]), dest)
    assert getattr(p.parse_args(argv), dest) \
        == getattr(jp.parse_args(argv), dest)


def test_server_sampling_defaults_as_jax():
    """--xtc-*, --dynatemp-* and --top-nsigma set the server-wide sampling
    defaults the JAX CLI sets (its _default_sampling), field for field."""
    argv = ["--xtc-probability", "0.5", "--xtc-threshold", "0.2",
            "--dynatemp-range", "0.3", "--dynatemp-exp", "1.5",
            "--top-nsigma", "2", "--temp", "0.7"]
    got = cli._default_sampling(cli.build_parser().parse_args(argv))
    want = jcli._default_sampling(jcli.build_parser().parse_args(argv))
    for f in ("xtc_probability", "xtc_threshold", "top_n_sigma",
              "dynatemp_range", "dynatemp_exponent", "temp"):
        assert getattr(got, f) == getattr(want, f), f


def test_chat_template_kwargs_and_no_cache_prompt_reach_the_server(
        model_path):
    engine, srv = cli.build_server(
        ["-m", model_path, "--device", "cpu", "--port", "0", "--no-jinja",
         "-np", "1", "-c", "64", "--weights-dtype", "f32",
         "--no-cache-prompt", "--chat-template-kwargs",
         '{"enable_thinking": false}', "-s", "3", "-sp", "--no-warmup"])
    try:
        assert srv.RequestHandlerClass.routes.chat_template_kwargs \
            == {"enable_thinking": False}
        assert engine.ecfg.prompt_cache is False
    finally:
        srv.server_close()
        engine.stop()


LORA_CVEC_FLAGS = [
    (["--lora", "a.gguf", "--lora", "b.gguf"], "lora"),
    (["--lora-scaled", "a.gguf", "0.5", "--lora-scaled", "b.gguf", "2"],
     "lora_scaled"),
    (["--lora-init-without-apply"], "lora_init_without_apply"),
    (["--lora-per-request"], "lora_per_request"),
    (["--control-vector", "c.gguf", "--control-vector", "d.gguf"],
     "control_vector"),
    (["--control-vector-scaled", "c.gguf", "0.8"], "control_vector_scaled"),
    (["--control-vector-layer-range", "2", "6"],
     "control_vector_layer_range"),
    (["-l", "29871+1.5", "-l", "5-inf", "--logit-bias", "7-0.5"],
     "logit_bias"),
    (["-to", "30"], "timeout"), (["--timeout", "45"], "timeout"),
    (["-e"], "escape"), (["--escape"], "escape"), (["--no-escape"], "escape"),
    (["--system-info"], "system_info"), (["--list-devices"], "list_devices"),
]


@pytest.mark.parametrize("argv,dest", LORA_CVEC_FLAGS,
                         ids=[" ".join(a) for a, _ in LORA_CVEC_FLAGS])
def test_lora_cvec_and_remaining_flags_parse_as_jax(argv, dest):
    """The lora and control-vector groups, -l/--logit-bias, -to/--timeout,
    -e/--escape/--no-escape, --system-info and --list-devices: the JAX
    parser's values, set and unset."""
    p, jp = cli.build_parser(), jcli.build_parser()
    assert getattr(p.parse_args([]), dest) == getattr(jp.parse_args([]), dest)
    assert getattr(p.parse_args(argv), dest) \
        == getattr(jp.parse_args(argv), dest)


def test_logit_bias_defaults_as_jax():
    """-l entries become the server's default logit bias as the JAX CLI
    parses them (signed values; "inf" with either sign bans the token, the
    JAX parser's reading; a malformed entry ignored)."""
    argv = ["-l", "29871+1.5", "-l", "5-inf", "-l", "7-0.5", "-l", "9+inf",
            "-l", "bad", "-l", "3*2"]
    got = cli._default_sampling(cli.build_parser().parse_args(argv))
    want = jcli._default_sampling(jcli.build_parser().parse_args(argv))
    assert got.logit_bias == want.logit_bias == {
        29871: 1.5, 5: float("-inf"), 7: -0.5, 9: float("-inf")}


def test_system_info_prints_and_exits(capsys):
    assert cli.main(["--system-info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("llama-box-tpu-torch") and "torch" in out


@pytest.mark.parametrize("mode", ["per_request", "static"])
def test_lora_requests_and_adapter_list(tmp_path, model_path, mode):
    """--lora-per-request: a chat with a `lora` field is answered (no
    400), an id past the adapters is a 400, and GET /lora-adapters lists
    {"id", "path", "scale"} as the JAX CLI builds it. Static adapters
    (merged): any `lora` id is out of range, as in JAX."""
    import json
    import threading
    import urllib.error
    import urllib.request
    from .test_torch_lora import SHAPES, write_lora
    a = write_lora(str(tmp_path / "a.gguf"), 1, list(SHAPES), 4, 8.0)
    b = write_lora(str(tmp_path / "b.gguf"), 2, ["attn_v"], 2, 4.0)
    argv = ["-m", model_path, "--device", "cpu", "--port", "0",
            "--no-jinja", "-np", "2", "-c", "128", "--weights-dtype", "f32",
            "--lora", a, "--lora-scaled", b, "0.5"]
    if mode == "per_request":
        argv.append("--lora-per-request")
    engine, srv = cli.build_server(argv)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % srv.server_address[:2]

    def post(body):
        req = urllib.request.Request(
            url + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        with urllib.request.urlopen(url + "/lora-adapters", timeout=30) as r:
            assert json.loads(r.read()) == [
                {"id": 0, "path": a, "scale": 1.0},
                {"id": 1, "path": b, "scale": 0.5}]
        body = {"messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 4, "temperature": 0}
        if mode == "per_request":
            assert engine.n_lora == 2 and engine.cfg.rope_mode == "norm"
            out = post(dict(body, lora=[{"id": 1, "scale": 0.25}]))
            assert out["choices"][0]["message"]["content"] is not None
            assert engine._lora_rows.tolist()[0] in ([1.0, 0.25],
                                                     [1.0, 0.5])
        else:
            assert engine.n_lora == 0
        with pytest.raises(urllib.error.HTTPError) as e:
            post(dict(body, lora=[{"id": 2}]))
        assert e.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
