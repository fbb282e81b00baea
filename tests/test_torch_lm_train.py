"""The port's training substrate (``repro_torch.train``,
``repro_torch.launch.train``) against the JAX package's, on the CPU.

AdamW leaf by leaf and the train step run in f32 (both packages'
``ACT_DTYPE`` set to float32): values agree to ``F32_RTOL`` relative, the
updated parameters and moments to ``UPD_RTOL`` relative with an absolute
floor of ``UPD_RTOL`` x the leaf's largest value (summation orders).
One Adam step moves an element by about ``lr`` x sign(gradient), so an
element whose gradient is zero up to rounding may move the other way in
one package: ``_params_close`` allows 2 x lr a step on at most
``FLIP_SHARE`` of the elements, and nowhere else.  The pipeline's batches
and the checkpoints' bytes are compared exactly.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import train as j_train
from repro.models import model as j_model
from repro.train import checkpoint as j_checkpoint
from repro.train import optimizer as j_opt
from repro.train.pipeline import DataPipeline as JPipeline
from repro.train.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models import model as t_model
from repro_torch.train import optimizer as t_opt
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.fault_tolerance import (
    PreemptionHandler,
    StragglerMonitor,
    run_with_retries,
)
from repro_torch.train.pipeline import DataPipeline, PipelineConfig
from test_torch_lm_model import _guard, routes  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parent.parent
F32_RTOL = 1e-5
UPD_RTOL = 1e-4
FLIP_SHARE = 1e-3
BF16_LOSS_RTOL = 2e-2  # about five bf16 roundings (2**-8 each) of the loss


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(j_model, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(t_model, "ACT_DTYPE", torch.float32)


def _reference(arch="qwen2-1.5b", seed=0):
    cfg = j_get_config(arch, reduced=True)
    params = jax.tree.map(np.asarray, j_model.get_model(cfg).init(jax.random.PRNGKey(seed)))
    model = t_model.get_model(get_config(arch, reduced=True), device="cpu")
    model.load_state_dict(convert.from_numpy(model.cfg, params))
    return cfg, params, model


def _close(got, want, rtol=UPD_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _params_close(got: dict, want: dict, lr_steps: float):
    """Leaf by leaf; elements beyond ``UPD_RTOL`` only where a near-zero
    gradient's sign flipped: at most 2 x (Σ lr) away, on at most
    ``FLIP_SHARE`` of the leaf."""
    for name, w in want.items():
        g, w = got[name].detach().numpy(), np.asarray(w, np.float32)
        off = ~np.isclose(g, w, rtol=UPD_RTOL, atol=UPD_RTOL * np.abs(w).max())
        assert off.mean() <= FLIP_SHARE, (name, off.mean())
        assert np.abs(g - w).max() <= 2 * lr_steps * (1 + 1e-3), name


def _grads(params, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32), params)


# ---------------------------------------------------------------- AdamW


@pytest.mark.parametrize("gscale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_leaf_by_leaf(gscale):
    cfg, params, model = _reference()
    acfg = j_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    tcfg = t_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    jp, jo = jax.tree.map(jnp.asarray, params), j_opt.adamw_init(params)
    tp = model.params()
    to = t_opt.adamw_init(tp)
    for step in range(3):
        g = _grads(params, step, gscale)
        jp, jo, jm = j_opt.adamw_update(jp, jax.tree.map(jnp.asarray, g), jo, acfg)
        tm = t_opt.adamw_update(tp, convert.from_numpy(cfg, g), to, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=F32_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=F32_RTOL)
    want_p, want_o = convert.flat(jax.tree.map(np.asarray, jp)), jax.tree.map(np.asarray, jo)
    assert int(to["step"]) == int(want_o["step"]) == 3 and to["step"].dtype == torch.int32
    for name, p in tp.items():  # the gradients are equal: no sign can flip
        _close(p.detach(), want_p[name])
        _close(to["m"][name], convert.flat(want_o["m"])[name])
        _close(to["v"][name], convert.flat(want_o["v"])[name])


def test_weight_decay_reaches_stacked_norms_and_biases_only():
    """``p.ndim >= 2`` decays: the stacked ``(L, d)`` norm scales and
    ``(L, out)`` biases decay as the reference's do, ``final_norm`` not."""
    cfg, params, model = _reference()
    acfg = j_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    zero = jax.tree.map(np.zeros_like, params)
    jp, _, _ = j_opt.adamw_update(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, zero),
                                  j_opt.adamw_init(params), acfg)
    tp = model.params()
    t_opt.adamw_update(tp, convert.from_numpy(cfg, zero), t_opt.adamw_init(tp),
                       t_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5))
    want = convert.flat(jax.tree.map(np.asarray, jp))
    for name in ("layers.ln1.scale", "layers.ln2.scale", "layers.attn.wq.b", "final_norm.scale"):
        np.testing.assert_array_equal(tp[name].detach().numpy(), want[name])
    lr = float(j_opt.schedule(acfg, jnp.asarray(1)))
    np.testing.assert_allclose(tp["layers.ln1.scale"].detach().numpy(), 1 - lr * 0.5, rtol=1e-6)
    assert bool((tp["final_norm.scale"] == 1).all())


@pytest.mark.parametrize("step", [0, 1, 50, 100, 1000, 10_000], ids=lambda s: f"step{s}")
def test_schedule(step):
    """Step 1, the end of warmup, the middle of the cosine, the last step."""
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
    got = t_opt.schedule(t_opt.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = j_opt.schedule(j_opt.AdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=F32_RTOL)


def test_global_norm_and_init():
    _, params, model = _reference()
    g = _grads(params, 1)
    got = t_opt.global_norm(convert.from_numpy(model.cfg, g))
    np.testing.assert_allclose(float(got), float(j_opt.global_norm(g)), rtol=F32_RTOL)
    state = t_opt.adamw_init(model.params())
    assert set(state["m"]) == set(model.params()) and int(state["step"]) == 0
    assert all(t.dtype == torch.float32 and not t.any() for t in state["v"].values())


def test_adamw_reduces_quadratic_loss():
    cfg = t_opt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0], requires_grad=True)}
    opt = t_opt.adamw_init(params)
    for _ in range(100):
        params["w"].grad = None
        (params["w"] ** 2).sum().backward()
        metrics = t_opt.adamw_update(params, {"w": params["w"].grad}, opt, cfg)
    assert float((params["w"].detach() ** 2).sum()) < 1e-2
    assert float(metrics["grad_norm"]) > 0


def test_schedule_warmup_and_decay():
    cfg = t_opt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(t_opt.schedule(cfg, 5)) < 1.0
    assert float(t_opt.schedule(cfg, 10)) == pytest.approx(1.0, rel=1e-3)
    assert float(t_opt.schedule(cfg, 100)) == pytest.approx(cfg.min_lr_frac, rel=1e-2)


# ---------------------------------------------------------------- the train step


@pytest.mark.parametrize("accum", [1, 2])
def test_three_train_steps_match_the_reference(accum, f32):
    cfg, params, model = _reference("minitron-4b", 2)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    j_step = j_train.build_train_step(j_model.get_model(cfg), j_opt.AdamWConfig(**kw), accum)
    t_step = train.build_train_step(model, t_opt.AdamWConfig(**kw), accum)
    pipe = DataPipeline(PipelineConfig(cfg.vocab, 32, 4))
    jp, jo = jax.tree.map(jnp.asarray, params), j_opt.adamw_init(params)
    to = t_opt.adamw_init(model.params())
    for step in range(3):
        batch = pipe.local_batch_at(step)
        jp, jo, jl, jm = j_step(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, tm = t_step(to, {k: torch.tensor(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tl), float(jl), rtol=F32_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=UPD_RTOL)
    lr_sum = sum(float(j_opt.schedule(j_opt.AdamWConfig(**kw), jnp.asarray(s)))
                 for s in (1, 2, 3))
    _params_close(model.params(), convert.flat(jax.tree.map(np.asarray, jp)), lr_sum)


def test_train_step_bf16_as_shipped():
    cfg, params, model = _reference("qwen2-1.5b", 3)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=2)
    j_step = j_train.build_train_step(j_model.get_model(cfg), j_opt.AdamWConfig(**kw))
    t_step = train.build_train_step(model, t_opt.AdamWConfig(**kw))
    batch = DataPipeline(PipelineConfig(cfg.vocab, 64, 2)).local_batch_at(0)
    _, _, jl, jm = j_step(jax.tree.map(jnp.asarray, params), j_opt.adamw_init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tm = t_step(t_opt.adamw_init(model.params()), {k: torch.tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=BF16_LOSS_RTOL)


def test_accum_must_divide_the_batch():
    _, _, model = _reference()
    step = train.build_train_step(model, t_opt.AdamWConfig(), accum=3)
    batch = {k: torch.zeros((4, 8), dtype=torch.int32) for k in ("tokens", "labels")}
    with pytest.raises(ValueError, match="not divisible by accum=3"):
        step(t_opt.adamw_init(model.params()), batch)


# ---------------------------------------------------------------- pipeline


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_pipeline_batches_equal_the_reference_bit_for_bit(shards):
    kw = dict(vocab=151_936, seq_len=33, global_batch=8, seed=5)
    for step in (0, 1, 17):
        for i in range(shards):
            got = DataPipeline(PipelineConfig(**kw), i, shards).local_batch_at(step)
            want = JPipeline(JPipelineConfig(**kw), i, shards).local_batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_token_file_and_reshard(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(10_000, dtype=np.int32).tofile(path)
    kw = dict(vocab=1000, seq_len=16, global_batch=4, token_file=str(path))
    got, want = DataPipeline(PipelineConfig(**kw)), JPipeline(JPipelineConfig(**kw))
    for step in (0, 3, 200):
        np.testing.assert_array_equal(got.global_batch_at(step), want.global_batch_at(step))
    for i in range(2):
        np.testing.assert_array_equal(got.reshard(i, 2).local_batch_at(3)["tokens"],
                                      want.reshard(i, 2).local_batch_at(3)["tokens"])


def test_pipeline_determinism_and_elasticity():
    cfg = PipelineConfig(vocab=1000, seq_len=16, global_batch=8)
    full = DataPipeline(cfg, 0, 1)
    b_full = full.local_batch_at(5)
    b1, b2 = DataPipeline(cfg, 0, 2).local_batch_at(5), DataPipeline(cfg, 1, 2).local_batch_at(5)
    np.testing.assert_array_equal(np.concatenate([b1["tokens"], b2["tokens"]]), b_full["tokens"])
    parts = [full.reshard(i, 4).local_batch_at(5)["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), b_full["tokens"])
    np.testing.assert_array_equal(b_full["labels"], full.global_batch_at(5)[:, 1:])


# ---------------------------------------------------------------- checkpoints


def _state(model, seed=0):
    opt = t_opt.adamw_init(model.params())
    gen = torch.Generator().manual_seed(seed)
    for k in ("m", "v"):
        for t in opt[k].values():
            t.copy_(torch.rand(t.shape, generator=gen))
    opt["step"].fill_(7)
    return train.state_tree(model.params(), opt), opt


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        ck.save(step, {"a": tree["a"] * step, "b": {"c": tree["b"]["c"] * step}})
    ck.wait()
    assert ck.steps() == [2, 3]
    restored, step = ck.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(6).reshape(2, 3) * 3)
    assert restored["b"]["c"].dtype == torch.float32


def test_checkpoint_atomicity_tmpdirs_cleaned(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(7, {"x": torch.zeros(3)}, blocking=True)
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    assert os.listdir(tmp_path) == ["step_7"]


def test_checkpoint_layout_equals_the_reference(tmp_path):
    cfg, params, model = _reference()
    tree, opt = _state(model)
    Checkpointer(str(tmp_path / "port")).save(4, tree, blocking=True)
    ref_tree = convert.to_numpy(cfg, model.params(), opt)
    j_checkpoint.Checkpointer(str(tmp_path / "ref")).save(4, ref_tree, blocking=True)
    got, want = (tmp_path / "port" / "step_4", tmp_path / "ref" / "step_4")
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert "0__layers__attn__wq__w.npy" in os.listdir(got)
    assert json.loads((got / "manifest.json").read_text()) == json.loads(
        (want / "manifest.json").read_text())
    for name in os.listdir(want):
        assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_a_reference_step_restores_into_the_port(tmp_path):
    cfg, params, model = _reference()
    jopt = {"m": _grads(params, 1), "v": _grads(params, 2), "step": np.int32(5)}
    j_checkpoint.Checkpointer(str(tmp_path)).save(5, (params, jopt), blocking=True)
    fresh = t_model.get_model(model.cfg, device="cpu")
    fresh_opt = t_opt.adamw_init(fresh.params())
    restored, step = Checkpointer(str(tmp_path)).restore(
        train.state_tree(fresh.params(), fresh_opt))
    train.load_state(fresh.params(), fresh_opt, restored)
    assert step == 5 and int(fresh_opt["step"]) == 5
    for name, p in fresh.params().items():
        np.testing.assert_array_equal(p.detach().numpy(), convert.flat(params)[name])
        np.testing.assert_array_equal(fresh_opt["v"][name].numpy(), convert.flat(jopt["v"])[name])


def test_a_port_step_restores_into_the_reference(tmp_path):
    cfg, params, model = _reference(seed=1)
    tree, opt = _state(model, seed=2)
    Checkpointer(str(tmp_path)).save(9, tree, blocking=True)
    template = (params, j_opt.adamw_init(params))
    (rp, ro), step = j_checkpoint.Checkpointer(str(tmp_path)).restore(template)
    assert step == 9 and int(ro["step"]) == 7
    want_p, want_o = convert.to_numpy(cfg, model.params(), opt)
    for got, want in zip(jax.tree.leaves((rp, ro)), jax.tree.leaves((want_p, want_o))):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_checkpoint_refusals(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    with pytest.raises(FileNotFoundError):
        ck.restore({"x": torch.zeros(2)})
    ck.save(1, {"x": torch.zeros(2)}, blocking=True)
    with pytest.raises(ValueError, match="has shape"):
        ck.restore({"x": torch.zeros(3)})
    # a writer that fails is reported by the next wait()
    blocked = Checkpointer(str(tmp_path / "ro"))
    os.chmod(blocked.dir, 0o500)
    try:
        blocked.save(2, {"x": torch.zeros(2)})
        if os.access(blocked.dir, os.W_OK):  # privileged users write anyway
            blocked.wait()
        else:
            with pytest.raises(OSError):
                blocked.wait()
    finally:
        os.chmod(blocked.dir, 0o700)


# ---------------------------------------------------------------- fault tolerance


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=20, threshold=2.0)
    assert mon.summary() == {"steps": 0}
    for i in range(20):
        assert not mon.record(i, 1.0)
    assert mon.record(20, 5.0)
    assert mon.summary()["stragglers"] == 1


def test_preemption_handler_sigterm():
    h = PreemptionHandler()
    assert not h.should_stop
    os.kill(os.getpid(), signal.SIGTERM)
    assert h.should_stop
    h.restore()


def test_run_with_retries():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return "ok"

    assert run_with_retries(flaky, retries=3, backoff=0.0) == "ok"

    def always_fails():
        raise RuntimeError("permanent")

    with pytest.raises(RuntimeError):
        run_with_retries(always_fails, retries=1, backoff=0.0)


# ---------------------------------------------------------------- the launcher


ARGS = ["--reduced", "--global-batch", "2", "--seq-len", "32", "--log-every", "1",
        "--device", "cpu"]


def test_train_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        train.main(["--reduced", "--steps", "1"])
    assert e.value.code == 2
    assert "no CUDA device is available; pass --device cpu" in capsys.readouterr().err


def test_train_runs_as_a_module_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--steps", "3", "--accum", "2",
         *ARGS], capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("[train] arch=qwen2-1.5b params≈0.2M devices=1 (cpu)")
    assert [ln.split()[1] for ln in lines[1:4]] == ["step=0", "step=1", "step=2"]
    assert lines[-1].startswith("[train] done: 3 steps in ")
    bare = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "1"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert bare.returncode == 2 and bare.stdout == ""
    assert "runs on CUDA and no CUDA device is available" in bare.stderr


def test_a_resumed_run_continues_the_uninterrupted_one(tmp_path):
    whole = train.main(["--steps", "5", *ARGS])
    first = train.main(["--steps", "5", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), *ARGS])
    assert first["losses"] == whole["losses"]
    assert Checkpointer(str(tmp_path)).steps() == [2, 4, 5]
    for s in (4, 5):  # back to the state after steps 0..2
        os.rename(tmp_path / f"step_{s}", tmp_path / f".old_{s}")
    resumed = train.main(["--steps", "5", "--ckpt-dir", str(tmp_path), *ARGS])
    assert resumed["step0"] == 3 and resumed["steps"] == [3, 4]
    assert resumed["losses"] == whole["losses"][3:]
    assert resumed["grad_norms"] == whole["grad_norms"][3:]


def test_families_not_ported_stop_the_launcher():
    """No family stops the launcher now: the reduced whisper-medium (audio,
    the last ported) takes a step on the CPU behind its zero frames."""
    run = train.main(["--arch", "whisper-medium", "--steps", "1", *ARGS])
    assert run["arch"] == "whisper-medium" and run["steps"] == [0]
    assert np.isfinite(run["losses"][0]) and np.isfinite(run["grad_norms"][0])


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-vl-7b"])
def test_launcher_steps_match_the_reference(arch, f32, routes):
    """Three steps of ``launch/train.main`` (f32 activations) against the
    reference's ``build_train_step`` from the same initial parameters (the
    launcher's seed-0 draw, converted), on the same pipeline batches with
    zero bf16 vision patches for ``vlm``, as both launchers add them; the
    MoE routing of every reference call clears the margin guard."""
    steps = 3
    run = train.main(["--arch", arch, "--steps", str(steps), *ARGS])
    cfg = get_config(arch, reduced=True)
    start = t_model.get_model(cfg, device="cpu").init(
        torch.Generator(device="cpu").manual_seed(0))
    jp = jax.tree.map(jnp.asarray, convert.to_numpy(cfg, start.params()))
    jcfg = j_get_config(arch, reduced=True)
    acfg = j_opt.AdamWConfig(lr=3e-4, total_steps=steps, warmup_steps=max(1, steps // 20))
    j_step = j_train.build_train_step(j_model.get_model(jcfg), acfg)
    jo = j_opt.adamw_init(jp)
    pipe = JPipeline(JPipelineConfig(cfg.vocab, 32, 2))
    want_l, want_g = [], []
    for step in range(steps):
        batch = {k: jnp.asarray(v) for k, v in pipe.local_batch_at(step).items()}
        if cfg.family == "vlm":
            batch["patches"] = jnp.zeros((2, cfg.vision_patches, cfg.d_model), jnp.bfloat16)
        jp, jo, jl, jm = j_step(jp, jo, batch)
        want_l.append(float(jl))
        want_g.append(float(jm["grad_norm"]))
    if cfg.moe:
        _guard(routes, cfg)
        assert all(np.isfinite(run["aux"])) and min(run["aux"]) > 0
    else:
        assert run["aux"] == [0.0] * steps
    assert run["steps"] == list(range(steps))
    np.testing.assert_allclose(run["losses"], want_l, rtol=F32_RTOL)
    np.testing.assert_allclose(run["grad_norms"], want_g, rtol=UPD_RTOL)


def test_weight_decay_reaches_every_expert_leaf():
    """The stacked MoE leaves (``router`` (L, d, E), the experts (L, E, …))
    decay under ``p.ndim >= 2`` as the reference's do."""
    cfg, params, model = _reference("moonshot-v1-16b-a3b")
    acfg = j_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5)
    zero = jax.tree.map(np.zeros_like, params)
    jp, _, _ = j_opt.adamw_update(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, zero),
                                  j_opt.adamw_init(params), acfg)
    tp = model.params()
    before = {n: p.detach().clone() for n, p in tp.items()}
    t_opt.adamw_update(tp, convert.from_numpy(cfg, zero), t_opt.adamw_init(tp),
                       t_opt.AdamWConfig(lr=0.1, warmup_steps=1, weight_decay=0.5))
    want = convert.flat(jax.tree.map(np.asarray, jp))
    experts = [n for n in tp if n.startswith("layers.moe.")]
    assert sorted(experts) == ["layers.moe.router", "layers.moe.wd", "layers.moe.wg",
                               "layers.moe.wu"]
    for name in experts:
        np.testing.assert_allclose(tp[name].detach().numpy(), want[name], rtol=1e-6)
        assert not torch.equal(tp[name].detach(), before[name])
