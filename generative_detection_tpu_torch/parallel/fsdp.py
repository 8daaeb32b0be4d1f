"""FSDP, ZeRO stage 3: every rank keeps a 1/W shard of the parameters
(``create_train_state(fsdp=True)`` of the JAX package, where XLA gathers each
weight at its use site).

The flat slice. ``FlatShard`` lays tensors end to end, each flattened in its
logical (NCHW) order, and gives rank r of W the elements [r k, (r + 1) k), k =
ceil(n / W). ZeRO-1 (``train/state.py``) keeps the Adam moments of such a slice
of all the parameters; FSDP keeps one slice a unit, padded with zeros to k
elements, so every rank's shard has one size.

The unit. ``shard_module(root, units)`` takes each module of ``units`` and,
last, ``root`` itself with the parameters no unit holds: each becomes a unit
whose parameters leave their modules (an attribute then holds a meta tensor of
the parameter's shape, dtype and strides) for one flat parameter,
``fsdp_flat``, registered on the unit's module: this rank's padded shard.

- Forward: the unit's module's ``forward`` all-gathers the shard and copies
  each parameter, in its own strides, into a tensor of its own that the
  module's attributes hold while the forward runs; after it they hold the meta
  tensors again, and nothing else holds the gathered weights.
- What autograd saves: inside a unit's forward, a saved-tensor hook swaps each
  tensor that is a gathered weight or a view of one for a placeholder; the
  backward's first unpack of a unit's placeholder gathers the unit again, and
  the gathered copy is dropped when the unit's last live placeholder is (its
  node ran, or its graph was freed). That covers every backward through the
  unit: the step's ``torch.autograd.grad`` calls through LPIPS and the
  discriminator as much as the net's. Autocast's cast of a gathered weight
  (bfloat16: 2 B an element) is a tensor of its own, saved as it is until the
  backward; the float32 gather it was cast from is not held.
- Gradients: the gather is an autograd function whose backward lays the
  weights' gradients out flat, reduce-scatters them (the sum over the ranks)
  and divides by W: this rank's shard of ``parallel.mesh.average_gradients``'
  mean, which autograd sums into ``fsdp_flat.grad``, across an accumulation
  window too.

State dicts stay unsharded: ``module.state_dict()`` of a sharded module
gathers every unit (a collective: every rank calls it) and returns the keys,
order and strides of the unsharded module; ``load_state_dict`` takes an
unsharded state dict and keeps this rank's shard (a subset of a unit's keys,
as ``strict=False`` overlays load, gathers that unit first). The optimizer's
side is ``train/state.py``'s ``ClippedAdam`` over the flat shards.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .mesh import all_gather_cat, reduce_scatter, world

FLAT = "fsdp_flat"  # the name of a unit's shard on its module

class FlatShard:
    """Rank ``rank`` of ``size``'s slice of tensors of ``numels`` elements,
    laid end to end in their logical order: [r k, (r + 1) k) with k =
    ceil(n / size), clipped to n in ``shard_range``."""

    def __init__(self, numels: Sequence[int], rank: int, size: int):
        self.numels = [int(n) for n in numels]
        self.n = sum(self.numels)
        self.per_rank = -(-self.n // size)
        lo = rank * self.per_rank
        self.shard_range = (min(lo, self.n), min(lo + self.per_rank, self.n))

    def slice(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's elements of ``tensors`` (shaped as the numels say),
        flattened in their logical order, without padding."""
        lo, hi = self.shard_range
        parts, start = [], 0
        for t in tensors:
            end = start + t.numel()
            if end > lo and start < hi:
                parts.append(t.reshape(-1)[max(lo - start, 0): min(hi, end) - start])
            start = end
        return torch.cat(parts) if parts else tensors[0].new_zeros(0)

    def padded(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """``slice`` with zeros after it up to ``per_rank`` elements."""
        part = self.slice(tensors)
        out = part.new_zeros(self.per_rank)
        out[: part.numel()] = part
        return out

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """Every rank's shard in rank order: all the elements, padded at the
        end to ``per_rank`` times the world (a collective)."""
        if shard.numel() != self.per_rank:
            buf = shard.new_zeros(self.per_rank)
            buf[: shard.numel()] = shard
            shard = buf
        return all_gather_cat(shard)

    def write(self, tensors: Sequence[torch.Tensor], flat: torch.Tensor) -> None:
        """Copy ``flat``'s elements into ``tensors`` in their logical order."""
        start = 0
        for t in tensors:
            t.copy_(flat[start: start + t.numel()].view(t.shape))
            start += t.numel()


# storage address of a gathered weight while its unit's forward runs -> (unit, index)
_LIVE: Dict[int, Tuple["Unit", int]] = {}
_HOOKS = {"depth": 0, "ctx": None}


class _Saved:
    """A placeholder autograd saves for a gathered weight or a view of one:
    ``load`` re-gathers its unit when needed."""

    __slots__ = ("unit", "index", "size", "stride", "offset")

    def __init__(self, unit: "Unit", index: int, t: torch.Tensor):
        self.unit, self.index = unit, index
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()
        unit.pending += 1

    def load(self) -> torch.Tensor:
        p = self.unit.regathered()[self.index]
        return p.as_strided(self.size, self.stride, self.offset)

    def __del__(self):
        self.unit.release()


def _pack(t: torch.Tensor):
    if t.device.type == "meta":
        return t
    hit = _LIVE.get(t.untyped_storage().data_ptr())
    if hit is not None and t.dtype == hit[0].dtypes[hit[1]]:
        return _Saved(hit[0], hit[1], t)
    return t


def _unpack(x):
    return x.load() if isinstance(x, _Saved) else x


@contextlib.contextmanager
def _saving():
    """The placeholder hooks, installed once around the outermost unit's
    forward (a root unit's forward holds the others')."""
    if _HOOKS["depth"] == 0:
        _HOOKS["ctx"] = torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
        _HOOKS["ctx"].__enter__()
    _HOOKS["depth"] += 1
    try:
        yield
    finally:
        _HOOKS["depth"] -= 1
        if _HOOKS["depth"] == 0:
            ctx, _HOOKS["ctx"] = _HOOKS["ctx"], None
            ctx.__exit__(None, None, None)


class _Gather(torch.autograd.Function):
    """flat shard -> the unit's weights, each in its own strides; backward:
    their gradients reduce-scattered into the shard's, the mean over the
    ranks."""

    @staticmethod
    def forward(ctx, unit: "Unit", flat: torch.Tensor):
        ctx.fsdp_unit = unit
        return unit.gather_params(flat)

    @staticmethod
    def backward(ctx, *grads):
        return None, ctx.fsdp_unit.scatter_grads(grads)


def _meta_like(shape, stride, dtype) -> torch.Tensor:
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


class Unit:
    """The parameters of ``slots`` (under ``module``) as one flat shard,
    ``module.fsdp_flat``, gathered while ``module``'s forward runs."""

    def __init__(self, module: nn.Module, slots: List[Tuple[nn.Module, str, str]],
                 rank: int, size: int):
        self.module = module
        self.slots = slots  # (owner module, attribute, name relative to module)
        params = [owner._parameters[attr] for owner, attr, _ in slots]
        grads = {p.requires_grad for p in params}
        if len(grads) > 1:
            raise ValueError(f"an FSDP unit mixes trained and frozen parameters: "
                             f"{type(module).__name__}")
        self.shapes = [p.shape for p in params]
        self.strides = [p.stride() for p in params]
        self.dtypes = [p.dtype for p in params]
        if len(set(self.dtypes)) > 1:
            raise ValueError(f"an FSDP unit mixes dtypes: {type(module).__name__}")
        self.flat_shard = FlatShard([p.numel() for p in params], rank, size)
        flat = self.flat_shard.padded([p.detach() for p in params])
        for owner, attr, _ in slots:
            p = owner._parameters.pop(attr)
            object.__setattr__(owner, attr, _meta_like(p.shape, p.stride(), p.dtype))
        module.register_parameter(FLAT, nn.Parameter(flat, requires_grad=grads.pop()))
        self.params: Optional[Tuple[torch.Tensor, ...]] = None  # while the forward runs
        self.pending = 0  # live placeholders of this unit
        self._live: Optional[Tuple[torch.Tensor, ...]] = None  # re-gathered for a backward
        self.gathers = 0  # all-gathers of this unit's shard since it was made

    @property
    def flat(self) -> nn.Parameter:
        return self.module._parameters[FLAT]

    @property
    def names(self) -> List[str]:
        return [rel for _, _, rel in self.slots]

    def numels(self) -> List[int]:
        return self.flat_shard.numels

    # -- gathers ---------------------------------------------------------------------

    def split(self, full: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """A flat tensor of the unit's elements as one tensor a parameter, in
        the parameters' shapes and strides."""
        out, start = [], 0
        for shape, stride, n in zip(self.shapes, self.strides, self.numels()):
            t = torch.empty_strided(shape, stride, dtype=full.dtype, device=full.device)
            t.copy_(full[start: start + n].view(shape))
            out.append(t)
            start += n
        return tuple(out)

    def gather_params(self, flat: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """The unit's full parameters, gathered from every rank's shard (a
        collective)."""
        self.gathers += 1
        with torch.no_grad():
            return self.split(self.flat_shard.gather((self.flat if flat is None else flat).detach()))

    def scatter_grads(self, grads) -> torch.Tensor:
        """The parameters' gradients (None: zero) laid out flat and
        reduce-scattered: this rank's shard of their mean over the ranks."""
        ref = self.flat
        full = torch.zeros(self.flat_shard.per_rank * world().size, dtype=ref.dtype,
                           device=ref.device)
        start = 0
        for g, shape, n in zip(grads, self.shapes, self.numels()):
            if g is not None:
                full[start: start + n].view(shape).copy_(g)
            start += n
        return reduce_scatter(full).div_(world().size)

    def regathered(self) -> Tuple[torch.Tensor, ...]:
        if self._live is None:
            self._live = self.gather_params()
        return self._live

    def release(self) -> None:
        self.pending -= 1
        if self.pending == 0:
            self._live = None

    # -- the forward -------------------------------------------------------------------

    def _install(self, params) -> None:
        self.params = params
        for i, ((owner, attr, _), t) in enumerate(zip(self.slots, params)):
            object.__setattr__(owner, attr, t)
            _LIVE[t.untyped_storage().data_ptr()] = (self, i)

    def _uninstall(self) -> None:
        for (owner, attr, _), t, shape, stride, dtype in zip(
                self.slots, self.params, self.shapes, self.strides, self.dtypes):
            _LIVE.pop(t.untyped_storage().data_ptr(), None)
            object.__setattr__(owner, attr, _meta_like(shape, stride, dtype))
        self.params = None

    def wrap(self, forward):
        def gathered_forward(*args, **kwargs):
            self._install(_Gather.apply(self, self.flat))
            try:
                with _saving():
                    return forward(*args, **kwargs)
            finally:
                self._uninstall()

        return gathered_forward

    def held(self) -> bool:
        """True when a full copy of the unit's parameters is held: inside its
        forward, or re-gathered for a backward."""
        return self.params is not None or self._live is not None

    # -- state dicts -------------------------------------------------------------------

    def _state_dict_hook(self, module, state_dict, prefix, local_metadata):
        """Replace ``fsdp_flat`` by the unit's parameters, gathered, and put
        the module's keys back in the unsharded order."""
        section = {k: state_dict.pop(k) for k in [k for k in state_dict if k.startswith(prefix)]}
        section.pop(prefix + FLAT)
        for rel, t in zip(self.names, self.gather_params()):
            section[prefix + rel] = t
        for rel in self.order:
            state_dict[prefix + rel] = section.pop(prefix + rel)
        state_dict.update(section)

    def _load_pre_hook(self, module, state_dict, prefix, local_metadata, strict, missing_keys,
                       unexpected_keys, error_msgs):
        """Turn the unit's unsharded entries into this rank's ``fsdp_flat``."""
        keys = [prefix + rel for rel in self.names]
        present = [k in state_dict for k in keys]
        if not any(present):
            missing_keys.extend(keys)
            state_dict[prefix + FLAT] = self.flat.detach()
            return
        current = None if all(present) else self.gather_params()
        values = []
        for i, (k, shape) in enumerate(zip(keys, self.shapes)):
            if k not in state_dict:
                missing_keys.append(k)
                values.append(current[i])
                continue
            v = state_dict.pop(k)
            if v.shape != shape:
                error_msgs.append(f"size mismatch for {k}: copying a param with shape "
                                  f"{tuple(v.shape)} from checkpoint, the shape in current "
                                  f"model is {tuple(shape)}.")
                v = self.flat.new_zeros(shape) if current is None else current[i]
            values.append(v)
        state_dict[prefix + FLAT] = self.flat_shard.padded(
            [v.to(device=self.flat.device, dtype=self.flat.dtype) for v in values])


def _param_slots(module: nn.Module, skip: Sequence[nn.Module] = ()):
    """(owner, attribute, name relative to ``module``) of every parameter
    under ``module`` outside the subtrees of ``skip``, in ``parameters()``
    order."""
    held = {id(m) for s in skip for m in s.modules()}
    out = []
    for name, sub in module.named_modules():
        if id(sub) in held:
            continue
        for attr, p in sub._parameters.items():
            if p is not None:
                out.append((sub, attr, f"{name}.{attr}" if name else attr))
    return out


def shard_module(root: nn.Module, units: Sequence[nn.Module] = ()) -> List[Unit]:
    """Shard ``root`` over the process group (``world()``; outside one a
    world of one, whose shards are whole): one unit each module of ``units``
    (disjoint subtrees, each gathered by its own forward), then ``root`` with
    the parameters no unit holds (gathered by ``root``'s forward). Returns
    the units, ``root``'s last when it holds any."""
    if is_sharded(root):
        raise ValueError("module is sharded already")
    w = world()
    order = list(root.state_dict().keys())
    every = _param_slots(root)
    made = [(m, _param_slots(m)) for m in units]
    made = [(m, slots) for m, slots in made if slots]
    rest = [] if any(m is root for m, _ in made) else _param_slots(root, [m for m, _ in made])
    if rest:
        made.append((root, rest))
    out = []
    for m, slots in made:
        unit = Unit(m, slots, w.rank, w.size)
        prefix = _prefix_of(root, m)
        unit.order = [k[len(prefix):] for k in order if k.startswith(prefix)]
        m.forward = unit.wrap(m.forward)
        m._register_state_dict_hook(unit._state_dict_hook)
        m.register_load_state_dict_pre_hook(unit._load_pre_hook)
        out.append(unit)
    index = {(id(owner), attr): (u, i) for u in out for i, (owner, attr, _) in enumerate(u.slots)}
    root._fsdp_units = out
    root._fsdp_layout = [index[(id(owner), attr)] for owner, attr, _ in every]
    return out


def _prefix_of(root: nn.Module, module: nn.Module) -> str:
    if module is root:
        return ""
    for name, sub in root.named_modules():
        if sub is module:
            return name + "."
    raise ValueError("unit is not a submodule of root")


def is_sharded(module: nn.Module) -> bool:
    return bool(getattr(module, "_fsdp_units", None))


def units_of(module: nn.Module) -> List[Unit]:
    """The units of a module that ``shard_module`` sharded (none else)."""
    return list(getattr(module, "_fsdp_units", None) or [])


def layout(module: nn.Module) -> Optional[List[Tuple[Unit, int]]]:
    """Each parameter of a sharded module, in the order the unsharded
    module's ``parameters()`` lists them, as (unit, index in the unit); None
    for a module that is not sharded."""
    return getattr(module, "_fsdp_layout", None) if is_sharded(module) else None
