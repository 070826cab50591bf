"""Checkpoints in the reference format — ``ckpts/hybrid_ep{ep:04d}.pt``.

A checkpoint is one ``torch.save`` dict with the reference trainer's keys
(reference train.py:682-708): module state_dicts ``encoder``, ``pf``,
``lf``; EMA shadows ``ema_pf``, ``ema_lf`` keyed like the state_dicts;
``opt`` (the AdamW state_dict, three groups as the reference's); ``args``
(the Config as a dict), ``cond_dim``, ``epoch``, ``global_step``.
pcfm/interop/torch_ckpt.py:state_from_reference_ckpt reads it unchanged,
so a port checkpoint loads into the JAX package.

``auto_resume`` restores with the reference's tolerance (train.py:459-516,
as pcfm/train/checkpoint.py:restore_tolerant): entries whose name and shape
match are loaded and the rest keeps its fresh value (non-strict model load;
for the EMA shadows, the key union with the current shadow); the optimizer
state is restored all or nothing, with a warning when it does not fit; the
reference's legacy top-level keys ``model`` and ``opt_main`` are read as
``pf`` and ``opt``, here and in ``load``, and a state_dict saved from a
live DDP wrapper loses its uniform ``module.`` prefix
(``normalise_reference_ckpt``).  ``load`` is the one reader of a
checkpoint into modules, a port run's or the reference's
(pcfm_torch.interop imports through it): it reads ``args`` with
``config_from_reference_args`` (no ``ctx_dtype`` means the reference's
fp32 ContextNet island), fills the non-float entries that the
reference's EMA shadows lack from the live state_dict, and loads every
module strictly, naming what does not fit as a ValueError.
Old checkpoints are deleted down to the newest ``keep_last_ckpts``.

Saves may be asynchronous (``async_save``, pcfm/train/checkpoint.py:21,
69-82): the state is copied to host memory on the caller's thread, so the
next steps may change the live tensors at once, and written on a
background thread, at most one save in flight.  ``wait_for_saves`` blocks
until it is on disk (and raises what the writer raised); ``find_latest``,
``restore_tolerant`` and ``gc_old`` call it first, as the train loop does
at its end.
"""
from __future__ import annotations

import dataclasses
import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple, Union

import torch

from pcfm_torch.config import Config
from pcfm_torch.train.state import ModelBundle, TrainState

_CKPT_RE = re.compile(r"hybrid_ep(\d+)\.pt$")
# the reference's legacy top-level keys (train.py:487,504)
LEGACY_KEY_MAP = {"model": "pf", "opt_main": "opt"}
MODULE_KEYS = ("encoder", "pf", "lf", "ema_pf", "ema_lf", "adv")


def ckpt_dir(out_dir: str) -> str:
    return os.path.join(os.path.abspath(out_dir), "ckpts")


# the background writer and its save in flight (at most one)
_WRITER = {"pool": None, "pending": None}


def wait_for_saves() -> None:
    """Block until the save in flight, if any, is on disk; re-raise its
    error."""
    pending: Optional[Future] = _WRITER["pending"]
    _WRITER["pending"] = None
    if pending is not None:
        pending.result()


def _to_cpu(x):
    """A host copy of every tensor in ``x`` that no later step changes
    (``.cpu()`` of a CPU tensor would be the tensor itself)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def save(out_dir: str, epoch: int, bundle: ModelBundle,
         global_step: int = 0,
         opt: Union[torch.optim.Optimizer, dict, None] = None,
         keep_last: int = 0, async_save: bool = False) -> str:
    """Write the bundle's modules, ``opt`` (an optimizer, or the state
    dict of one, as a checkpoint carries it) and the run's counters; with
    ``async_save`` the file is written on the background thread (the
    path is returned at once)."""
    wait_for_saves()
    d = ckpt_dir(out_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"hybrid_ep{epoch:04d}.pt")
    ckpt = {k: _to_cpu(m.state_dict()) for k, m in bundle.modules().items()}
    if opt is not None:
        ckpt["opt"] = _to_cpu(opt if isinstance(opt, dict)
                              else opt.state_dict())
    ckpt.update(args=dataclasses.asdict(bundle.cfg),
                cond_dim=int(bundle.cfg.cond_dim), epoch=int(epoch),
                global_step=int(global_step))
    if async_save:
        if _WRITER["pool"] is None:
            _WRITER["pool"] = ThreadPoolExecutor(
                1, thread_name_prefix="pcfm-ckpt")
        _WRITER["pending"] = _WRITER["pool"].submit(
            _write, ckpt, path, out_dir, keep_last)
    else:
        _write(ckpt, path, out_dir, keep_last)
    return path


def _write(ckpt: dict, path: str, out_dir: str, keep_last: int) -> None:
    tmp = f"{path}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)               # a reader never sees half a file
    _gc(out_dir, keep_last)


def _list(out_dir: str) -> list:
    """[(epoch, path)] of the checkpoints under out_dir, oldest first."""
    d = ckpt_dir(out_dir)
    if not os.path.isdir(d):
        return []
    return sorted((int(m.group(1)), os.path.join(d, fn))
                  for fn in os.listdir(d) if (m := _CKPT_RE.match(fn)))


def find_latest(out_dir: str) -> Tuple[Optional[str], int]:
    """(path, epoch) of the newest checkpoint, or (None, 0)."""
    wait_for_saves()
    found = _list(out_dir)
    return (found[-1][1], found[-1][0]) if found else (None, 0)


def gc_old(out_dir: str, keep_last: int) -> None:
    """Delete all but the newest ``keep_last`` checkpoints (0: keep all)."""
    wait_for_saves()
    _gc(out_dir, keep_last)


def _gc(out_dir: str, keep_last: int) -> None:
    if keep_last > 0:
        for _, path in _list(out_dir)[:-keep_last]:
            os.remove(path)


# ------------------------------------------------ the reference's variants
#
# pcfm/interop/torch_ckpt.py:54-60,263-279,325-341: the same rules.

def unwrap_ddp(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Strip a uniform 'module.' prefix (a state_dict taken from a live
    DistributedDataParallel wrapper; the reference trainer unwraps before
    saving, train.py:687-689, but hand-rolled exports often don't)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def normalise_reference_ckpt(ckpt: dict) -> dict:
    """A copy of a loaded checkpoint with the legacy keys read as ``pf`` /
    ``opt`` and every module state_dict unwrapped (its order kept)."""
    ckpt = dict(ckpt)
    for old, new in LEGACY_KEY_MAP.items():
        if old in ckpt and new not in ckpt:
            ckpt[new] = ckpt.pop(old)
    for key in MODULE_KEYS:
        if ckpt.get(key):
            ckpt[key] = unwrap_ddp(dict(ckpt[key]))
    return ckpt


def config_from_reference_args(args: Dict[str, Any], cond_dim=None,
                               **overrides) -> Config:
    """The port's Config from the ``args`` dict stored in a checkpoint:
    known fields only, ``cond_dim`` from the checkpoint, and the
    ContextNet island in fp32 unless the args say otherwise, since the
    reference trained with the exact fp32 island (reference
    models.py:513)."""
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in args.items() if k in fields}
    if cond_dim is not None:
        kw["cond_dim"] = int(cond_dim)
    kw.setdefault("ctx_dtype", "fp32")
    kw.update(overrides)
    return Config(**kw)


def ema_state_dict(ema: dict, live: dict) -> dict:
    """An EMA shadow's state_dict: the reference's EMA registers the float
    entries only (util.py:11-24), so the others (``num_batches_tracked``)
    come from the live state_dict."""
    return {**{k: v for k, v in live.items()
               if k not in ema and not v.is_floating_point()}, **ema}


def _load_checked(module: torch.nn.Module, sd: dict, where: str) -> None:
    """Strict load that names what does not fit (a missing, extra or
    misshapen entry) as a ValueError."""
    own = module.state_dict()
    missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or extra:
        raise ValueError(f"{where}: state_dict mismatch; missing="
                         f"{missing[:8]} extra={extra[:8]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{where}.{k}: shape {tuple(v.shape)} != "
                             f"expected {tuple(own[k].shape)}")
    module.load_state_dict(sd)


def _read(path: str) -> dict:
    return normalise_reference_ckpt(
        torch.load(path, map_location="cpu", weights_only=True))


def load(path: str, device, overrides: Optional[dict] = None
         ) -> Tuple[Config, ModelBundle, dict]:
    """Rebuild (cfg, bundle, ckpt) from a checkpoint, the port's or the
    reference's.  ``overrides`` replaces Config fields (None values are
    ignored) before the modules are built; weights load strictly; the EMA
    shadows are the checkpoint's, or its live weights where it has none;
    ``ckpt`` is the normalised dict."""
    ckpt = _read(path)
    args = ckpt["args"]
    cfg = config_from_reference_args(
        args, cond_dim=ckpt.get("cond_dim", args.get("cond_dim")),
        **{k: v for k, v in (overrides or {}).items() if v is not None})
    # the initial draw is overwritten by the checkpoint's weights
    bundle = ModelBundle(cfg, device, torch.Generator().manual_seed(0))
    for key, module in bundle.modules().items():
        live = ckpt.get(key.replace("ema_", ""))
        if live is None:
            raise ValueError(f"checkpoint has no "
                             f"'{key.replace('ema_', '')}'")
        _load_checked(module, ema_state_dict(ckpt[key], live)
                      if key.startswith("ema_") and ckpt.get(key)
                      else live, key)
    return cfg, bundle, ckpt


def _load_matching(module: torch.nn.Module, sd: dict) -> Tuple[int, list]:
    """Load the entries of ``sd`` whose name and shape match; the rest of
    ``module`` keeps its value.  Returns (loaded count, kept names)."""
    own = module.state_dict()
    take = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    module.load_state_dict(take, strict=False)
    return len(take), sorted(set(own) - set(take))


def _opt_fits(opt: torch.optim.Optimizer, sd: dict) -> bool:
    """Every saved moment has its parameter's shape (torch's own
    load_state_dict checks only the group sizes)."""
    params = [p for g in opt.param_groups for p in g["params"]]
    for idx, st in sd.get("state", {}).items():
        if not 0 <= int(idx) < len(params):
            return False
        for key in ("exp_avg", "exp_avg_sq"):
            if key in st and tuple(st[key].shape) != tuple(
                    params[int(idx)].shape):
                return False
    return True


def restore_tolerant(path: str, state: TrainState,
                     verbose: bool = True) -> dict:
    """Non-strict restore of ``path`` into ``state``; returns the
    checkpoint dict (see the module docstring)."""
    wait_for_saves()
    ckpt = _read(path)
    n_loaded, kept = 0, []
    for key, module in state.bundle.modules().items():
        # a checkpoint without EMA shadows seeds them from the live weights
        sd = ckpt.get(key) or ckpt.get(key.replace("ema_", "")) or {}
        n, k = _load_matching(module, sd)
        n_loaded += n
        kept += [f"{key}/{name}" for name in k]
    opt_sd = ckpt.get("opt")
    why = "absent" if opt_sd is None else ""
    if opt_sd is not None and not _opt_fits(state.opt, opt_sd):
        why = "moment shapes differ from this run's parameters"
    if not why:
        try:     # torch builds the new state first: a failure changes nothing
            state.opt.load_state_dict(opt_sd)
        except (ValueError, KeyError) as e:
            why = str(e)
    if verbose:
        print(f"[Auto-Resume] tolerant restore: {n_loaded} loaded, "
              f"{len(kept)} kept fresh"
              + (f", optimizer state RESET ({why})" if why else ""))
        for name in kept[:8]:
            print(f"[Auto-Resume][WARN] kept fresh: {name}")
    state.step = int(ckpt.get("global_step", 0) or 0)
    return ckpt


def auto_resume(out_dir: str, state: TrainState,
                verbose: bool = True) -> Tuple[int, int]:
    """Restore the newest checkpoint, if any.  Returns (start_epoch,
    global_step); start_epoch is 1 when there is no checkpoint."""
    path, ep = find_latest(out_dir)
    if path is None:
        if verbose:
            print("[Auto-Resume] No checkpoint found. "
                  "Start training from scratch.")
        return 1, 0
    if verbose:
        print(f"[Auto-Resume] Found latest ckpt: {path} (ep={ep})")
    ckpt = restore_tolerant(path, state, verbose=verbose)
    last_epoch = int(ckpt.get("epoch", ep))
    if verbose:
        print(f"[Auto-Resume] Resume from epoch {last_epoch}.")
    return last_epoch + 1, state.step
