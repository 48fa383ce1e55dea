"""Role-keyed ``.pth`` files in the reference layout.

Counterpart of ``export_role_keyed``/``load_role_keyed`` in
``diga_tpu/utils/checkpoint.py`` (:72-89): the reference saves one
``state_dict`` per role (student.pth, teacher.pth, enc_s.pth, ...,
util/utils.py:83-91).
"""

from __future__ import annotations

import os

import torch

from ..models.convert import load_torch_state_dict


def export_role_keyed(out_dir: str, roles: dict[str, dict]) -> None:
    """Write {role: state_dict} as <out_dir>/<role>.pth (tensors on the CPU)."""
    os.makedirs(out_dir, exist_ok=True)
    for role, sd in roles.items():
        tensors = {k: torch.as_tensor(v).detach().cpu().contiguous() for k, v in sd.items()}
        torch.save(tensors, os.path.join(out_dir, f"{role}.pth"))


def load_role_keyed(in_dir: str, roles: list[str]) -> dict[str, dict[str, torch.Tensor]]:
    """Read <in_dir>/<role>.pth files into CPU-tensor state_dicts."""
    return {r: load_torch_state_dict(os.path.join(in_dir, f"{r}.pth")) for r in roles}
