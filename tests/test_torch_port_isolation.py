"""The port stands alone: it imports nothing of JAX or of the JAX package,
its own copies (Config, the train parser) agree with the JAX package's, and
its entry points go to the card unless the caller asks for the CPU."""
import argparse
import contextlib
import dataclasses
import io
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
        "'pcfm_torch.interop', 'pcfm_torch.utils.flops'} "
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


def test_check_single_device_rejects_only_grain():
    from pcfm_torch.train.loop import check_single_device
    with pytest.raises(NotImplementedError,
                       match="loader_backend='grain': not yet ported"):
        check_single_device(Config(loader_backend="grain"))
    check_single_device(Config(dp=4, sp=2))      # the grid checks the sizes


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


def test_resolve_device(no_cuda):
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device(None)
    with pytest.raises(ValueError, match="one of"):
        tdevice.resolve_device("mps")
