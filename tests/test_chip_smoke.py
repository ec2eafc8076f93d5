"""The parts of ``chip_smoke.py`` and of its helpers that run without a card:
the comparison bars, the channel-count fit, the refusal of a CPU platform,
the compile-cache path, the card description, and the trace reduction."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frame(rng, n=1024):
    thr = np.abs(rng.randn(4, n)) + 1.0
    pk = rng.rand(4, n) < 0.01
    return thr, pk


@pytest.mark.parametrize("rel_err,flips,ok", [
    (0.0, 0, True), (5e-5, 0, True), (2e-4, 0, False), (0.0, 5, False),
])
def test_float_bar(smoke, rng, rel_err, flips, ok):
    thr_ref, pk_ref = _frame(rng)
    thr = thr_ref * (1 + rel_err * (thr_ref == thr_ref.max()))
    pk = pk_ref.copy()
    pk.flat[:flips] = ~pk.flat[:flips]
    errs = smoke.float_errors(thr, pk, thr_ref, pk_ref)
    assert errs["flips"] == flips and errs["cells"] == thr_ref.size
    assert errs["dthr"] == pytest.approx(rel_err, abs=1e-12)
    if ok:
        smoke.check_float(errs)
    else:
        with pytest.raises(smoke.PhaseFailed):
            smoke.check_float(errs)


def test_float_bar_rejects_an_empty_reference(smoke, rng):
    thr_ref, _ = _frame(rng)
    none = np.zeros(thr_ref.shape, bool)
    with pytest.raises(smoke.PhaseFailed, match="detects nothing"):
        smoke.check_float(smoke.float_errors(thr_ref, none, thr_ref, none))


def test_exact_bar(smoke, rng):
    thr = rng.randint(0, 1000, (4, 256))
    pk = rng.rand(4, 256) < 0.05
    smoke.check_exact(smoke.exact_errors(thr, pk, thr, pk))
    off = thr.copy()
    off[0, 0] += 1
    with pytest.raises(smoke.PhaseFailed, match="bit-exact"):
        smoke.check_exact(smoke.exact_errors(off, pk, thr, pk))


@pytest.mark.parametrize("shift,ok", [(0.0, True), (1.0, True), (3.0, False)])
def test_wire_bar(smoke, rng, shift, ok):
    """Packed words decode to the threshold field; one cell off by 3 LSB
    breaks the 2-LSB bar, and a dense 1-LSB offset would break the mean."""
    from rsp_chains import packing

    thr_ref, pk_ref = _frame(rng)
    thr_ref = thr_ref * 40
    thr = np.floor(thr_ref)
    thr[0, 5] += shift
    words = np.asarray(packing.pack_cfar_words(thr, pk_ref, 10))
    errs = smoke.wire_errors(words, thr_ref, pk_ref, 10)
    assert errs["max_lsb"] == shift and errs["flips"] == 0
    if ok:
        smoke.check_wire(errs)
    else:
        with pytest.raises(smoke.PhaseFailed):
            smoke.check_wire(errs)
    dense = np.asarray(packing.pack_cfar_words(np.floor(thr_ref) + 1,
                                               pk_ref, 10))
    with pytest.raises(smoke.PhaseFailed, match="mean"):
        smoke.check_wire(smoke.wire_errors(dense, thr_ref, pk_ref, 10))


class _Compiled:
    def __init__(self, need):
        self.need = need

    def memory_analysis(self):
        class M:
            argument_size_in_bytes = 0
            output_size_in_bytes = 0
            temp_size_in_bytes = self.need
        return M()


def test_fit_channels_picks_largest_power_of_two(smoke):
    """A footprint of 3 GiB per channel on a 100 GiB card: 64 misses, the
    linear estimate jumps straight to 16 (3 x 16 = 48 <= 90), which fits."""
    tried = []

    def compile_at(c):
        tried.append(c)
        return _Compiled(3 * c * 2**30)

    c, compiled = smoke.fit_channels(compile_at, 100 * 2**30)
    assert c == 16 and tried == [64, 16]
    assert smoke.footprint(compiled) == 48 * 2**30
    assert smoke.fit_channels(lambda c: _Compiled(c), 2**30)[0] == 64


def test_fit_channels_raises_when_nothing_fits(smoke):
    with pytest.raises(smoke.PhaseFailed, match="not even one channel"):
        smoke.fit_channels(lambda c: _Compiled(2**40), 2**30)


def test_refuses_a_cpu_platform(smoke, capsys):
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_script_exits_nonzero_off_the_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_exits_nonzero(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_require_gpu_refuses_cpu():
    from rsp_chains.utils.device import require_gpu

    with pytest.raises(RuntimeError, match="'cpu'"):
        require_gpu()


def test_compile_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    import jax

    from rsp_chains.utils import device

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert device.enable_compile_cache(tmp_path) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, tmp_path):
    import jax

    from rsp_chains.utils import device

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache(tmp_path)
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert device.CHECKOUT == ROOT
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_card_description_joins_cards(monkeypatch, tmp_path):
    """One ``name, power limit`` entry per card, as nvidia-smi prints it."""
    from rsp_chains.utils.device import card_description

    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 700.00 W'\n"
                    "echo 'NVIDIA H100 80GB HBM3, 500.00 W'\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    assert card_description() == ("NVIDIA H100 80GB HBM3, 700.00 W; "
                                  "NVIDIA H100 80GB HBM3, 500.00 W")


def test_trace_reduction_by_stage(tmp_path):
    """A traced call reduces to device time per chain stage through the
    compiled module's op_name metadata (here on the CPU plane: the reduction,
    not a device time)."""
    import jax
    import jax.numpy as jnp

    from rsp_chains.utils import profiling

    def f(x):
        with jax.named_scope("stage_a"):
            y = jnp.sin(x) @ x
        with jax.named_scope("stage_b"):
            return jnp.cumsum(jnp.cos(y), -1) * 2

    x = jnp.ones((256, 256))
    compiled = jax.jit(f).lower(x).compile()
    names = profiling.hlo_op_names(compiled.as_text())
    assert any(v.endswith("stage_a/sin") for v in names.values())
    compiled(x).block_until_ready()
    with profiling.trace(str(tmp_path)):
        compiled(x).block_until_ready()
    per, kernels, busy, window = profiling.device_time_by_stage(
        profiling.xplane_file(str(tmp_path)), ("stage_a", "stage_b"), names,
        plane_prefix="/host:CPU")
    assert per.get("stage_a", 0) > 0 and per.get("stage_b", 0) > 0
    assert 0 < busy <= window + 1e-9
    assert sum(per.values()) >= busy - 1e-9
    assert sum(kernels.values()) == pytest.approx(sum(per.values()))
    json.dumps(per)
