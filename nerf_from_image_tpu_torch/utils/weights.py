"""Weights carried across from the JAX package.

The JAX package's module trees mirror the reference PyTorch state-dict
names and store torch layouts (OIHW convs, [out, in] linears), so a JAX
variable tree becomes a state_dict for this port's modules by joining the
tree paths with '.' and applying the same small rename table. No tensor
is re-laid out. The encoder's keys go through models/encoder.py's
`encoder_rename`, the reference state-dict names.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from nerf_from_image_tpu_torch.models.encoder import encoder_rename


def _default_rename(path: str) -> str:
    """Maps a dot-joined JAX variable path to a torch state-dict key (this
    package's copy of nerf_from_image_tpu/utils/torch_interop.py's table)."""
    replacements = [
        ("mapping_network.", "mapping_network.backbone."),
        ("net_0", "net.0"),
        ("net_2", "net.2"),
        ("viewdir_output", "viewdir_mapper.output"),
        (".embedding", ".weight"),  # nn.Embed
    ]
    for old, new in replacements:
        path = path.replace(old, new)
    # ResidualEncoder instance norms: norm3_weight -> norm3.weight
    parts = path.split(".")
    last = parts[-1]
    for norm_suffix in ("_weight", "_bias"):
        if last.endswith(norm_suffix) and last.startswith("norm"):
            parts[-1] = last[: -len(norm_suffix)] + "." + norm_suffix[1:]
            path = ".".join(parts)
    return path


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}.{k}" if prefix else str(k))
    else:
        yield prefix, tree


def generator_state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `Generator.init(...)` variable tree of numpy arrays (collections
    'params' and 'buffers') -> a state_dict for this port's Generator.

    Load it with `load_state_dict(sd, strict=True)`.
    """
    sd: Dict[str, torch.Tensor] = {}
    for tree in variables_np.values():
        for path, value in _flatten(tree):
            key = _default_rename(path)
            if key in sd:
                raise KeyError(f"two JAX variables map to the key {key!r}")
            sd[key] = torch.from_numpy(np.array(value))
    return sd


def encoder_state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `BootstrapEncoder.init(...)` variable tree of numpy arrays ->
    a state_dict for this port's models/encoder.py::BootstrapEncoder.

    The keys are `encoder_rename` of the dot-joined JAX paths: the
    reference encoder's state-dict keys, which are the port's parameter
    names. Layouts are torch's on both sides (OIHW convs, [out, in]
    linears). Load it with `load_state_dict(sd, strict=True)`.
    """
    sd: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(variables_np["params"]):
        key = encoder_rename(path)
        if key in sd:
            raise KeyError(f"two JAX variables map to the key {key!r}")
        sd[key] = torch.from_numpy(np.array(value))
    return sd


def lpips_state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `LPIPS` variable tree of numpy arrays -> a state_dict for this
    port's models/lpips.py::LPIPS.

    Unlike the generator's, these convolutions are flax `nn.Conv`: HWIO
    kernels, re-laid out here to torch's OIHW.
    """
    params = variables_np["params"]
    sd: Dict[str, torch.Tensor] = {}
    for name, conv in params["net"].items():
        i = int(name[len("conv"):])
        kernel = np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1))
        sd[f"net.convs.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel))
        sd[f"net.convs.{i}.bias"] = torch.from_numpy(np.array(conv["bias"]))
    for i in range(5):
        sd[f"lins.{i}"] = torch.from_numpy(np.array(params[f"lin{i}"]))
    return sd


# Positions of the 13 convolutions in torchvision's VGG16 `features`, which
# the `lpips` package keeps (split into slice1..slice5).
_LPIPS_CONV_POSITIONS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _slice_of(pos: int) -> int:
    """The `lpips` package's slice (1-5) holding torchvision layer `pos`."""
    for slice_idx, last in enumerate((3, 8, 15, 22), start=1):
        if pos <= last:
            return slice_idx
    return 5


def lpips_state_to_state_dict(torch_state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The `lpips` package's VGG16 state dict (keys `net.slice<k>.<pos>.*`
    or `features.<pos>.*` for the trunk, `lin<i>.model.1.weight` or
    `lins.<i>.model.1.weight` for the heads) -> a state_dict for this
    port's LPIPS (this package's copy of the JAX package's
    `lpips_state_to_variables`). Both are OIHW: no re-layout."""
    def find(*suffixes):
        for k, v in torch_state.items():
            if k.endswith(suffixes):
                return torch.as_tensor(np.asarray(v))
        return None

    sd: Dict[str, torch.Tensor] = {}
    for i, pos in enumerate(_LPIPS_CONV_POSITIONS):
        for part in ("weight", "bias"):
            v = find(f"features.{pos}.{part}", f"slice{_slice_of(pos)}.{pos}.{part}")
            if v is None:
                raise KeyError(f"VGG conv {pos} {part} not found in the lpips state")
            sd[f"net.convs.{i}.{part}"] = v.float()
    for i in range(5):
        v = find(f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight")
        if v is None:
            raise KeyError(f"LPIPS head lin{i} not found in the lpips state")
        sd[f"lins.{i}"] = v.float().reshape(-1)
    return sd
