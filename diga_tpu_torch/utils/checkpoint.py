"""Checkpoints: role-keyed ``.pth`` files and the full train state.

Counterpart of ``diga_tpu/utils/checkpoint.py`` (:41-89):

  * ``export_role_keyed``/``load_role_keyed``: one reference-layout
    ``state_dict`` per role (student.pth, teacher.pth, enc_s.pth, ...,
    reference util/utils.py:83-91);
  * ``save_train_state``/``restore_train_state``: the whole train state, so
    a resume is exact.  A ``ckpt_*/`` directory holds ``<role>.pth`` for
    every module, in ``export_role_keyed``'s format (so ``--weight_dir
    <wd>/ckpt_final`` and ``--load_weight_dir <wd>/ckpt_final`` read it as
    they read ``weights/``), and one ``state.pth`` with the rest: the step,
    the optimizers' state, and for the segmentation stages the centroids
    and every generator's state.  The state object gives and takes that
    split through its ``state_dict()``/``load_state_dict()``
    (``{"roles": {role: state_dict}, "state": {...}}``).
  * ``background=True`` takes the device-to-host snapshot inline and writes
    on one thread, as orbax's async checkpointer does; the next save and
    ``wait_for_checkpoints()`` join that thread and raise its error.

A checkpoint is written to a temporary directory beside its target and
renamed into place, so a crash never leaves half of one.  JAX's orbax
``ckpt_final`` and this package's cannot read each other; the role-keyed
``.pth`` files are what carry weights between the two packages.
"""

from __future__ import annotations

import os
import shutil
import threading

import torch

from ..models.convert import load_torch_state_dict

STATE_FILE = "state.pth"

_pending: threading.Thread | None = None
_pending_error: list[Exception] = []


def export_role_keyed(out_dir: str, roles: dict[str, dict]) -> None:
    """Write {role: state_dict} as <out_dir>/<role>.pth (tensors on the CPU)."""
    os.makedirs(out_dir, exist_ok=True)
    for role, sd in roles.items():
        tensors = {k: torch.as_tensor(v).detach().cpu().contiguous() for k, v in sd.items()}
        torch.save(tensors, os.path.join(out_dir, f"{role}.pth"))


def load_role_keyed(in_dir: str, roles: list[str]) -> dict[str, dict[str, torch.Tensor]]:
    """Read <in_dir>/<role>.pth files into CPU-tensor state_dicts."""
    return {r: load_torch_state_dict(os.path.join(in_dir, f"{r}.pth")) for r in roles}


def _to_host(obj):
    """A copy of ``obj`` with every tensor on the CPU, owning its memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write(path: str, snapshot: dict) -> None:
    tmp, old = f"{path}.tmp-{os.getpid()}", f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    export_role_keyed(tmp, snapshot["roles"])
    torch.save(snapshot["state"], os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _write_in_background(path: str, snapshot: dict) -> None:
    try:
        _write(path, snapshot)
    except Exception as e:  # raised again by wait_for_checkpoints
        _pending_error.append(e)


def wait_for_checkpoints() -> None:
    """Join the outstanding background write, if any; raise its error."""
    global _pending
    if _pending is not None:
        _pending.join()
        _pending = None
    if _pending_error:
        raise _pending_error.pop()


def save_train_state(path: str, state, background: bool = False) -> None:
    """Write ``state`` (a ``SegTrainState`` or ``TranslatorState``) to the
    directory ``path``, replacing what is there."""
    global _pending
    wait_for_checkpoints()
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    snapshot = _to_host(state.state_dict())
    if not background:
        _write(path, snapshot)
        return
    _pending = threading.Thread(target=_write_in_background, args=(path, snapshot),
                                name="save_train_state")
    _pending.start()


def restore_train_state(path: str, state):
    """Load the checkpoint directory ``path`` into ``state`` in place;
    returns ``state``."""
    roles = {f[:-len(".pth")] for f in os.listdir(path) if f.endswith(".pth")} - {"state"}
    sd = {"roles": load_role_keyed(path, sorted(roles)),
          "state": torch.load(os.path.join(path, STATE_FILE), map_location="cpu")}
    state.load_state_dict(sd)
    return state
