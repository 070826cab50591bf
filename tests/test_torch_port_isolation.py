"""The port stands alone: it imports nothing of JAX or of the JAX package,
its own copies (Config, the train parser) agree with the JAX package's, and
its entry points go to the card unless the caller asks for the CPU."""
import argparse
import contextlib
import dataclasses
import io
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from pcfm.config import Config as JaxConfig  # noqa: E402
from pcfm.train.cli import build_parser as jax_parser  # noqa: E402
from pcfm_torch import device as tdevice  # noqa: E402
from pcfm_torch.config import Config  # noqa: E402
from pcfm_torch.distill import cli as distill_cli  # noqa: E402
from pcfm_torch.eval import cli as eval_cli  # noqa: E402
from pcfm_torch.sample import cli as sample_cli  # noqa: E402
from pcfm_torch.train import cli as train_cli  # noqa: E402


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys, pcfm_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "pcfm_torch.__path__, 'pcfm_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'pcfm_torch.data.loader', 'pcfm_torch.utils.tb', "
        "'pcfm_torch.models.context', 'pcfm_torch.ops.voxel_sorted', "
        "'pcfm_torch.eval.cli', 'pcfm_torch.eval.metrics', "
        "'pcfm_torch.ops.emd', 'pcfm_torch.ops.sampling', "
        "'pcfm_torch.distill', 'pcfm_torch.distill.progressive', "
        "'pcfm_torch.distill.cli', 'pcfm_torch.models.adversary', "
        "'pcfm_torch.parallel', 'pcfm_torch.parallel.distributed', "
        "'pcfm_torch.parallel.mesh', 'pcfm_torch.parallel.sp_context', "
        "'pcfm_torch.parallel.collectives', 'pcfm_torch.parallel.sp_ops', "
        "'pcfm_torch.ops.ball_query', 'pcfm_torch.ops.interpolate', "
        "'pcfm_torch.ops.losses', 'pcfm_torch.nn.pointnet', "
        "'pcfm_torch.interop', 'pcfm_torch.utils.flops', "
        "'pcfm_torch.data.grain_loader', 'pcfm_torch.data.pack_h5', "
        "'pcfm_torch.native', 'pcfm_torch.native.build', "
        "'pcfm_torch.datagen', 'pcfm_torch.datagen.core', "
        "'pcfm_torch.datagen.glb', 'pcfm_torch.datagen.meshio', "
        "'pcfm_torch.datagen.bullet_kin', 'pcfm_torch.datagen.simulate', "
        "'pcfm_torch.datagen.cli', 'pcfm_torch.quality', "
        "'pcfm_torch.quality.common', 'pcfm_torch.quality.gen_quality', "
        "'pcfm_torch.quality.convergence_full', "
        "'pcfm_torch.quality.distill_demo'} "
        "<= set(names), names\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', "
        "'optax', 'orbax') or m == 'pcfm' or m.startswith('pcfm.') "
        "or m.startswith('jax.'))\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_config_matches_the_jax_config():
    def fields(cls):
        return {f.name: (f.default if f.default is not dataclasses.MISSING
                         else f.default_factory())
                for f in dataclasses.fields(cls)}
    assert fields(Config) == fields(JaxConfig)
    cfg = Config(has_rgb=True, use_rgb_in_latent=False, cond_dim=3)
    jcfg = JaxConfig(has_rgb=True, use_rgb_in_latent=False, cond_dim=3)
    for prop in ("enc_in_channels", "pf_point_dim", "pf_cond_dim"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert Config.from_json(cfg.to_json()) == cfg
    assert cfg.to_json() == jcfg.to_json()
    assert cfg.replace(seed=5).seed == 5 and cfg.seed == 123


def _options(parser: argparse.ArgumentParser) -> dict:
    return {tuple(a.option_strings): (a.dest, a.default, a.type, a.choices,
                                      a.nargs, a.const)
            for a in parser._actions if a.option_strings}


def test_train_parser_matches_the_jax_parser():
    port, jax = _options(train_cli.build_parser()), _options(jax_parser())
    device = port.pop(("--device",))
    assert device[1] == "cuda" and tuple(device[3]) == ("cuda", "cpu")
    assert port == jax


def test_parallel_imports_neither_jax_nor_the_jax_package():
    """pcfm_torch.parallel alone (the port's parallel training), and the
    train CLI that starts it, load no JAX: the parser keeps JAX's options,
    --dp and --sp among them, and adds none for the process group."""
    code = ("import sys, pcfm_torch.parallel, pcfm_torch.parallel.sp_ops, "
            "pcfm_torch.train.cli\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pcfm' or m.startswith('pcfm.'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    port = _options(train_cli.build_parser())
    assert {("--dp",), ("--sp",), ("--async_save",)} <= set(port)
    assert set(port) - set(_options(jax_parser())) == {("--device",)}


def test_loop_accepts_grain_and_builds_the_process_backend(monkeypatch,
                                                          tmp_path):
    """``loader_backend='grain'`` trains: the loop builds its train loader
    through ``make_loader``, the process backend for ``grain``, the thread
    loader for ``thread``, and refuses a backend it does not know."""
    from pcfm_torch.data.grain_loader import ProcessLoader, make_loader
    from pcfm_torch.data.loader import DataLoader
    from pcfm_torch.train import loop

    built = []

    class Stop(Exception):
        pass

    def spy(backend, *args, **kwargs):
        built.append(make_loader(backend, *args, **kwargs))
        return built[-1]

    def stop(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(loop, "make_loader", spy)
    monkeypatch.setattr(loop, "init_state", stop)
    for backend, kind in (("grain", ProcessLoader), ("thread", DataLoader)):
        cfg = Config(dataset_type="synthetic", loader_backend=backend,
                     num_workers=2, batch_size=4, tr_max_sample_points=16,
                     te_max_sample_points=16, out_dir=str(tmp_path))
        with pytest.raises(Stop):
            loop.train(cfg, verbose=False, device="cpu")
        assert type(built[-1]) is kind
        assert built[-1].num_workers == 2 and built[-1].drop_last
    with pytest.raises(ValueError, match="loader_backend"):
        loop.train(Config(dataset_type="synthetic", loader_backend="x",
                          out_dir=str(tmp_path)), verbose=False,
                   device="cpu")


def _help_options(main) -> set:
    """The option strings a CLI's --help lists."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(?<![\w-])--\w+", buf.getvalue()))


def test_eval_cli_options_are_the_jax_options_and_device():
    from pcfm.eval.cli import main as jax_eval_main
    port, jax = _help_options(eval_cli.main), _help_options(jax_eval_main)
    assert "--suite_seeds" in jax and "--help" in jax
    assert port == jax | {"--device"}
    device = _options(eval_cli.build_parser())[("--device",)]
    assert device[1] == "cuda" and tuple(device[3]) == ("cuda", "cpu")


def test_distill_parser_is_the_jax_parser_and_device(monkeypatch):
    """pcfm/distill/cli.py builds its parser inside main: take it there."""
    from pcfm.distill.cli import main as jax_distill_main

    class Parsed(Exception):
        pass

    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed):
            jax_distill_main(["--out_dir", "x"])
    port = _options(distill_cli.build_parser())
    device = port.pop(("--device",))
    assert device[1] == "cuda" and tuple(device[3]) == ("cuda", "cpu")
    assert ("--steps_per_phase",) in port
    assert port == _options(seen["parser"])


def _grab_parser(monkeypatch, main, argv) -> argparse.ArgumentParser:
    """The parser that ``main`` builds inside itself, taken at parse."""
    class Parsed(Exception):
        pass

    seen = {}

    def grab(self, *args, **kwargs):
        seen["parser"] = self
        raise Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Parsed):
            main(argv)
    return seen["parser"]


def test_pack_and_datagen_cli_options_are_the_jax_options(monkeypatch):
    """``python -m pcfm_torch.data.pack_h5`` takes scripts/pack_h5.py's
    options (its parser is built under ``__main__``: taken at parse), and
    ``python -m pcfm_torch.datagen.cli`` pcfm/datagen/cli.py's."""
    import runpy
    from pcfm.datagen.cli import build_parser as jax_datagen_parser
    from pcfm_torch.data import pack_h5
    from pcfm_torch.datagen.cli import build_parser as datagen_parser
    script = os.path.join(os.path.dirname(__file__), "..", "scripts",
                          "pack_h5.py")
    jax = _grab_parser(monkeypatch, lambda argv: runpy.run_path(
        script, run_name="__main__"), [])
    port = pack_h5.build_parser()
    assert _options(port) == _options(jax)
    assert ("--val_fraction",) in _options(port)
    assert _options(datagen_parser()) == _options(jax_datagen_parser())
    assert ("--ply-ascii",) in _options(datagen_parser())


def test_interop_cli_options_are_the_jax_options_and_device(monkeypatch):
    """``python -m pcfm_torch.interop``: pcfm/interop/__main__.py's
    arguments and options, plus ``--device``."""
    from pcfm.interop.__main__ import main as jax_interop_main
    from pcfm_torch import interop
    argv = ["ref.pt", "--out_dir", "x"]
    port = _options(_grab_parser(monkeypatch, interop.main, argv))
    jax = _options(_grab_parser(monkeypatch, jax_interop_main, argv))
    device = port.pop(("--device",))
    assert device[1] == "cuda" and tuple(device[3]) == ("cuda", "cpu")
    assert ("--ctx_dtype",) in port and port == jax
    positional = [[a.dest for a in p._actions if not a.option_strings]
                  for p in (_grab_parser(monkeypatch, interop.main, argv),
                            _grab_parser(monkeypatch, jax_interop_main,
                                         argv))]
    assert positional[0] == positional[1] == ["ckpt"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_cuda_or_an_explicit_cpu(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        sample_cli.main(["--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(["--dataset_type", "synthetic", "--out_dir",
                        str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        sample_cli.load_run(str(tmp_path))
    with pytest.raises(RuntimeError, match="--device cpu"):
        eval_cli.main(["--out_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        distill_cli.main(["--out_dir", str(tmp_path)])
    from pcfm_torch import interop
    with pytest.raises(RuntimeError, match="--device cpu"):
        interop.main([str(tmp_path / "ref.pt"), "--out_dir",
                      str(tmp_path)])
    # asked for, the CPU is taken (here: no checkpoint to load)
    with pytest.raises(FileNotFoundError):
        sample_cli.main(["--out_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        eval_cli.main(["--out_dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        distill_cli.main(["--out_dir", str(tmp_path), "--device", "cpu"])


QUALITY = {"gen_quality": "gen_quality_tpu.py",
           "convergence_full": "convergence_full.py",
           "distill_demo": "distill_demo.py"}


def _quality_main(name):
    import importlib
    return importlib.import_module(f"pcfm_torch.quality.{name}").main


@pytest.mark.parametrize("name", sorted(QUALITY))
def test_quality_clis_need_cuda_or_an_explicit_cpu(no_cuda, name,
                                                   tmp_path):
    with pytest.raises(RuntimeError, match="--device cpu"):
        _quality_main(name)(["--out", str(tmp_path)])


def _env_knobs(script: str) -> dict:
    """{knob: default} of a JAX harness's environment knobs, as written
    in its source (``os.environ.get("KNOB", default)``)."""
    import ast
    path = os.path.join(os.path.dirname(__file__), "..", "scripts", script)
    with open(path) as f:
        tree = ast.parse(f.read())
    knobs = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func,
                                                      ast.Attribute)
                and node.func.attr == "get"
                and ast.unparse(node.func.value) == "os.environ"):
            default = (ast.literal_eval(node.args[1])
                       if len(node.args) > 1 else None)
            knobs[node.args[0].value] = default
    return knobs


@pytest.mark.parametrize("name", sorted(QUALITY))
def test_quality_flags_are_the_jax_knobs(name):
    """Each quality CLI's flags are its JAX script's environment knobs,
    lower-cased, with their defaults, and ``--device``; the script's
    switch to the CPU (``GENQ_CPU``) is ``--device cpu``.  ``--out``
    keeps the default's name under this host's temporary directory."""
    import importlib
    mod = importlib.import_module(f"pcfm_torch.quality.{name}")
    port = _options(mod.build_parser())
    device = port.pop(("--device",))
    assert device[1] == "cuda" and tuple(device[3]) == ("cuda", "cpu")
    port.pop(("-h", "--help"))
    knobs = _env_knobs(QUALITY[name])
    knobs.pop("GENQ_CPU", None)
    assert set(port) == {(f"--{k.lower()}",) for k in knobs}
    for k, default in knobs.items():
        _, got, kind, _, _, _ = port[(f"--{k.lower()}",)]
        if k == "OUT":
            assert os.path.basename(got) == os.path.basename(default)
        else:
            assert got == kind(default), k


def test_dyn_parity_harness_takes_the_jax_harness_knobs(monkeypatch):
    """scripts/torch_dyn_parity.py: scripts/dyn_parity.py's options (its
    parser is built under ``__main__``: taken at parse) and ``run``'s
    keywords with their defaults; its JSON goes to a file of its own."""
    import inspect
    import runpy

    from scripts import dyn_parity, torch_dyn_parity
    script = os.path.join(os.path.dirname(__file__), "..", "scripts",
                          "dyn_parity.py")
    jax = _options(_grab_parser(monkeypatch, lambda argv: runpy.run_path(
        script, run_name="__main__"), []))
    port = _options(torch_dyn_parity.build_parser())
    out_jax, out_port = jax.pop(("--out_json",)), port.pop(("--out_json",))
    assert port == jax and out_port[0] == out_jax[0]
    assert out_port[1] != out_jax[1] == "docs/dyn_parity.json"
    assert (inspect.signature(torch_dyn_parity.run)
            == inspect.signature(dyn_parity.run))


def test_resolve_device(no_cuda):
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device(None)
    with pytest.raises(ValueError, match="one of"):
        tdevice.resolve_device("mps")
