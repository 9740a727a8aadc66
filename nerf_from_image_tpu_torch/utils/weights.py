"""Weights carried across from the JAX package and from the reference.

The JAX package's module trees mirror the reference PyTorch state-dict
names and store torch layouts (OIHW convs, [out, in] linears), so a JAX
variable tree becomes a state_dict for this port's modules by joining the
tree paths with '.' and applying the same small rename table. No tensor
is re-laid out. The encoder's keys go through models/encoder.py's
`encoder_rename`, the reference state-dict names.

The port's parameter names therefore are the reference's, and the
reference's released `.pth` checkpoints load directly
(`load_reference_generator`, `load_reference_encoder`), under the rules
of the JAX package's `state_dict_to_variables`: every parameter must be
found, every checkpoint entry used (but the reference's `resample_filter`
buffers), and a tensor is only reshaped where the sizes agree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

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


def state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX variable tree of numpy arrays -> a state_dict for the port's
    module of the same structure: a `Generator.init(...)` tree
    (collections 'params' and 'buffers'), conditional ones included
    (`emb.*` with its instance norms, `class_embedding.weight`,
    `mapping_network.backbone.*`), or a `Discriminator.init(...)` or
    `ResidualEncoder` tree (`backbone.*`, `label_embedding.weight`,
    `emb.*`): one rename serves them all.

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


def inception_rename(path: str) -> str:
    """JAX FIDInceptionV3 variable path -> pytorch-fid state-dict key, which
    is this port's parameter name (a copy of the JAX package's
    `inception_rename`)."""
    for old, new in (("conv_weight", "conv.weight"), ("bn_weight", "bn.weight"),
                     ("bn_bias", "bn.bias"), ("bn_running_mean", "bn.running_mean"),
                     ("bn_running_var", "bn.running_var")):
        path = path.replace(old, new)
    return path


def inception_state_dict_from_jax(variables_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX `FIDInceptionV3.init(...)` variable tree of numpy arrays
    (collections 'params' and 'buffers') -> a state_dict for this port's
    models/inception.py::FIDInceptionV3. Both are OIHW: no re-layout. Load
    it with `load_state_dict(sd, strict=True)`."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in variables_np.values():
        for path, value in _flatten(tree):
            key = inception_rename(path)
            if key in sd:
                raise KeyError(f"two JAX variables map to the key {key!r}")
            sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    return sd


def load_inception_weights(path: str) -> Dict[str, torch.Tensor]:
    """pytorch-fid's `pt_inception` weights (the `.pth` file that
    NFI_INCEPTION_WEIGHTS names) -> a state_dict for FIDInceptionV3, with
    the classifier (`fc.*`), the auxiliary head (`AuxLogits.*`) and batch
    norm's `num_batches_tracked` dropped. Load it with
    `load_state_dict(sd, strict=True)`."""
    sd = load_torch_checkpoint(path)
    return {k: v.float() for k, v in sd.items()
            if "fc." not in k and "AuxLogits" not in k
            and not k.endswith("num_batches_tracked")}


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


# Reference checkpoints written by the JAX package's orbax checkpointer
# need orbax, which this package does not import.
_NO_ORBAX = ("{path} is not a .pth file, so it is an orbax checkpoint of the JAX "
             "package; the port reads reference .pth checkpoints only (reading orbax "
             "needs the JAX package's libraries)")


def load_torch_checkpoint(path: str, key: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """A reference `.pth` checkpoint -> its state dict of CPU tensors.

    The reference saves pickled dicts like {'model_ema': state_dict,
    'model_coord': state_dict, ...}; `key` selects one entry. The file is
    unpickled (`weights_only=False`, as the JAX package reads it): load
    only checkpoints you trust, from the paths you pass.
    """
    if not path.endswith(".pth"):
        raise NotImplementedError(_NO_ORBAX.format(path=path))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if key is not None:
        ckpt = ckpt[key]
    return {k: torch.as_tensor(v).detach().cpu() for k, v in ckpt.items()}


def reference_state_dict(module: torch.nn.Module,
                         state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference state dict -> a state_dict for `module`, strictly:
    raises KeyError for a parameter the checkpoint lacks or an entry that
    no parameter takes (the reference's `resample_filter` buffers are
    skipped), ValueError for a size that differs; a tensor of the same
    size in another shape is reshaped."""
    want = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, ref in want.items():
        if key not in state_dict:
            raise KeyError(f"the checkpoint has no entry {key!r}")
        val = torch.as_tensor(state_dict[key])
        if tuple(val.shape) != tuple(ref.shape):
            if val.numel() != ref.numel():
                raise ValueError(f"shape mismatch for {key}: checkpoint "
                                 f"{tuple(val.shape)} vs model {tuple(ref.shape)}")
            val = val.reshape(ref.shape)
        out[key] = val.to(ref.dtype)
    leftovers = [k for k in state_dict
                 if k not in want and not k.endswith("resample_filter")]
    if leftovers:
        raise KeyError(f"unused checkpoint entries ({len(leftovers)}): {leftovers[:8]}")
    return out


def load_reference_generator(model: torch.nn.Module, path: str) -> None:
    """Loads the EMA generator (key 'model_ema') of a reference `.pth`
    checkpoint into this package's Generator, in place."""
    sd = load_torch_checkpoint(path, key="model_ema")
    model.load_state_dict(reference_state_dict(model, sd), strict=True)


def load_reference_encoder(encoder: torch.nn.Module, path: str) -> None:
    """Loads the bootstrap encoder (key 'model_coord', DataParallel
    'module.' prefixes dropped) of a reference `.pth` checkpoint into this
    package's BootstrapEncoder, in place."""
    sd = load_torch_checkpoint(path, key="model_coord")
    sd = {k.replace("module.", ""): v for k, v in sd.items()}
    encoder.load_state_dict(reference_state_dict(encoder, sd), strict=True)
