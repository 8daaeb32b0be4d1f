"""Serving: the per-patch 3D detector, patches -> encode -> pose decode (mode)
-> 3D boxes (``serving.py`` of the JAX package).

``make_detector_fn`` closes a network into a function of the patches and the
camera arguments. It runs on the card by default, in bfloat16 unless asked
otherwise.

``export_detector`` traces the same detector with ``torch.export`` into one
artifact, weights baked in; ``load_detector`` turns it back into a function
with ``detect``'s signature, in this process or another, and
``shard_detector`` serves it as one replica a device, each on its slice of
the batch::

    blob = export_detector(model, net, hmin_table, hmax_table, batch=None)
    open("detector.pt2", "wb").write(blob)
    # later, elsewhere (the package imported, so its gdt operators exist):
    detect = load_detector(open("detector.pt2", "rb").read())
    boxes_3d, class_id, score = detect(patches, focal, pp, patch_size, center, resampling)

Every kernel is a node of the ``gdt`` operator namespace (``ops/library.py``),
so the loaded graph launches the same kernels, built at their first launch,
and counts them as the live detector does. The artifact records what a graph
cannot hold (``META``): the compute dtype, under which the loaded function
runs (``ieee_fp32()`` for a float32 one), the device, and the switches the
trace saw (``GDT_FUSE_INFERENCE``, ``GDT_WINOGRAD``, ``GDT_SUBPIXEL_UP``),
which are baked into the graph as the JAX package bakes them into its
StableHLO. A card artifact runs only on a card: loading it where CUDA is
absent, or onto another device, raises.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Mapping, Optional, Sequence, Union

import torch
from torch import nn
from torch.export.graph_signature import InputKind

from .eval.inference import pose_inference, recover_boxes
from .models.autoencoder import cast_compute_dtype
from .ops.precision import compute_precision
from .parallel.mesh import local_batch_size


def _resolve_serve_dtype(dtype):
    """Serving compute dtype: ``"auto"`` reads ``GDT_SERVE_DTYPE`` and
    defaults to bfloat16 (the JAX package's serving default);
    ``None``/``"float32"`` keep the network's own dtype; a string or a torch
    dtype selects that dtype."""
    if dtype == "auto":
        dtype = os.environ.get("GDT_SERVE_DTYPE", "bfloat16")
    if dtype is None or dtype == "float32":
        return None
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown serving dtype {dtype!r}")
    return dtype


def _serving_net(model, state_dict_or_net, dtype, device):
    """(the network of ``model.inference_net()`` holding exactly the given
    weights, in the serving dtype on ``device``; the compute dtype)."""
    sd = (
        state_dict_or_net.state_dict()
        if isinstance(state_dict_or_net, nn.Module)
        else state_dict_or_net
    )
    net = model.inference_net()
    cast_compute_dtype(net, model.compute_dtype)
    net.load_state_dict(sd, strict=True)
    dtype = _resolve_serve_dtype(dtype)
    if dtype is not None:
        cast_compute_dtype(net, dtype)
    precision = dtype or model.compute_dtype
    return net.to(device=device, memory_format=torch.channels_last).eval(), precision


def make_detector_fn(
    model,
    state_dict_or_net: Union[Mapping[str, torch.Tensor], nn.Module],
    hmin_table,
    hmax_table,
    patch_out: int = 256,
    dtype="auto",
    device="cuda",
):
    """Return ``detect(rgb, focal, principal_point, patch_size, patch_center,
    resampling) -> (boxes_3d (B, 7), class_id (B,), score (B,))``.

    ``model`` is a ``PoseAutoencoder``; the weights come from a state_dict or
    from a network, which is copied and left as it is, into the network of
    ``model.inference_net()`` (fused GroupNorm+SiLU+conv kernels when
    ``GDT_FUSE_INFERENCE=1``, as the JAX package's ``pose_inference``
    builds it). The detector serves exactly these weights: ``ckpt_path`` is
    not read here, so a caller that wants a reference checkpoint applies
    ``model.maybe_init_from_ckpt(net)`` first, as the eval CLI does.
    In a reduced dtype,
    conv and dense weights are cast and GroupNorm affine stays float32; in
    float32 each call runs under ``ops.precision.ieee_fp32()`` (no TF32).
    Inputs may be numpy arrays or tensors; patches are (B, H, W, 3)."""
    net, precision = _serving_net(model, state_dict_or_net, dtype, device)
    hmin = torch.as_tensor(hmin_table, dtype=torch.float32, device=device)
    hmax = torch.as_tensor(hmax_table, dtype=torch.float32, device=device)

    def detect(rgb, focal, principal_point, patch_size, patch_center, resampling):
        args = [
            torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (rgb, focal, principal_point, patch_size, patch_center, resampling)
        ]
        with torch.inference_mode(), compute_precision(precision):
            dec_pose, _, _ = pose_inference(net, args[0])
            rec = recover_boxes(
                dec_pose, *args[1:], hmin_table=hmin, hmax_table=hmax, patch_out=patch_out
            )
        return rec["boxes_3d"], rec["class_id"], rec["score"]

    return detect


# the switches that change the traced graph, recorded beside it
SWITCHES = ("GDT_FUSE_INFERENCE", "GDT_WINOGRAD", "GDT_SUBPIXEL_UP")
META = "gdt_detector.json"  # the artifact's metadata, an extra file of torch.export.save


# the parts of the network that the detector does not run (encode and the
# pose decode do)
OFF_PATH = ("decoder", "post_quant_conv", "pose_encoder")


class DetectorModule(nn.Module):
    """The detector as one module for ``torch.export``: the serving network
    without the parts it does not run (``OFF_PATH``: removed from ``net``,
    so the artifact holds none of their weights), the pose decode's mode, the
    box recovery, and the hmin/hmax tables as buffers. Takes and returns what
    ``make_detector_fn``'s ``detect`` does, as float32 tensors on the
    module's device."""

    def __init__(self, net: nn.Module, hmin: torch.Tensor, hmax: torch.Tensor,
                 patch_out: int):
        super().__init__()
        for name in OFF_PATH:
            delattr(net, name)
        self.net = net
        self.register_buffer("hmin_table", hmin)
        self.register_buffer("hmax_table", hmax)
        self.patch_out = patch_out

    def forward(self, rgb, focal, principal_point, patch_size, patch_center, resampling):
        _, pose_feat = self.net.encode(rgb)
        dec_pose, _ = self.net._decode_pose(pose_feat, False)
        rec = recover_boxes(dec_pose, focal, principal_point, patch_size, patch_center,
                            resampling, hmin_table=self.hmin_table,
                            hmax_table=self.hmax_table, patch_out=self.patch_out)
        return rec["boxes_3d"], rec["class_id"], rec["score"]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def export_detector(
    model,
    state_dict_or_net: Union[Mapping[str, torch.Tensor], nn.Module],
    hmin_table,
    hmax_table,
    batch: Optional[int] = 8,
    input_size: Optional[int] = None,
    dtype="auto",
    device="cuda",
) -> bytes:
    """The detector of ``make_detector_fn`` (same weights, dtype and switches)
    traced by ``torch.export`` and saved (``torch.export.save``) into bytes.

    ``batch``: a fixed batch, or None for one symbolic batch dimension, so
    that one artifact serves any batch. ``input_size``: the patch side
    (``model.input_size`` by default). The six inputs are float32, (B, S, S,
    3), (B,), (B, 2), (B,), (B, 2), (B,), as the JAX package's
    ``export_detector``. ``device``: where the artifact runs; the card by
    default."""
    size = input_size or getattr(model, "input_size", 256)
    net, precision = _serving_net(model, state_dict_or_net, dtype, device)
    net.requires_grad_(False)
    tables = [torch.as_tensor(t, dtype=torch.float32, device=device).clone()
              for t in (hmin_table, hmax_table)]
    module = DetectorModule(net, *tables, size).eval()
    b = 2 if batch is None else batch
    shapes = ((b, size, size, 3), (b,), (b, 2), (b,), (b, 2), (b,))
    args = tuple(torch.zeros(s, dtype=torch.float32, device=device) for s in shapes)
    dynamic = None
    if batch is None:
        dim = torch.export.Dim("batch", min=1)
        dynamic = tuple({0: dim} for _ in shapes)
    with torch.no_grad(), compute_precision(precision):
        program = torch.export.export(module, args, dynamic_shapes=dynamic)
    meta = {
        "dtype": _dtype_name(precision), "device": torch.device(device).type,
        "batch": batch, "input_size": size,
        "switches": {k: os.environ.get(k) for k in SWITCHES},
        "torch": torch.__version__,
    }
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={META: json.dumps(meta)})
    return buf.getvalue()


def detector_metadata(blob: bytes) -> dict:
    """The metadata ``export_detector`` wrote beside the graph."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        name = next((n for n in z.namelist() if n.endswith("extra/" + META)), None)
        if name is None:
            raise ValueError("not an artifact of export_detector: no " + META)
        return json.loads(z.read(name))


def _graph_runner(program):
    """(the graph module of ``program``, its lifted tensors in placeholder
    order, the six user inputs' shapes with None at a symbolic dimension).
    Calling the graph with the lifted tensors and the inputs runs what
    ``program.module()`` runs, without fetching every weight through the
    module tree first (that cost ~1 ms a request on the H100's host)."""
    specs = program.graph_signature.input_specs
    state = {**program.state_dict, **program.constants}
    lifted = [state[s.target] for s in specs if s.kind != InputKind.USER_INPUT]
    user = [s.kind == InputKind.USER_INPUT for s in specs]
    if user != [False] * len(lifted) + [True] * 6:
        raise ValueError("not a detector graph: it does not take six inputs after its tensors")
    nodes = [n for n in program.graph.nodes if n.op == "placeholder"][len(lifted):]
    shapes = [tuple(d if isinstance(d, int) else None for d in n.meta["val"].shape)
              for n in nodes]
    return program.graph_module, lifted, shapes


def load_detector(blob: bytes, device="cuda"):
    """A function with the signature of ``make_detector_fn``'s ``detect`` from
    an ``export_detector`` artifact: inputs (numpy arrays or tensors) go to
    ``device`` as float32 and must have the graph's shapes (any batch where
    it was exported with ``batch=None``); the graph runs under
    ``inference_mode`` and the artifact's compute precision (IEEE fp32 for a
    float32 one). The artifact runs only on the device it was exported for:
    anything else raises."""
    meta = detector_metadata(blob)
    device = torch.device(device)
    if device.type != meta["device"]:
        raise ValueError(f"the detector was exported for {meta['device']}, not {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the detector was exported for the card and CUDA is not available")
    graph, lifted, shapes = _graph_runner(torch.export.load(io.BytesIO(blob)))
    precision = getattr(torch, meta["dtype"])

    def detect(rgb, focal, principal_point, patch_size, patch_center, resampling):
        args = [
            torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (rgb, focal, principal_point, patch_size, patch_center, resampling)
        ]
        for t, shape in zip(args, shapes):
            if (t.dim() != len(shape) or t.shape[0] != args[0].shape[0]
                    or any(w is not None and d != w for d, w in zip(t.shape, shape))):
                raise ValueError(f"detector inputs must have the shapes {shapes} (None: any "
                                 f"batch, the same for all), got {[tuple(a.shape) for a in args]}")
        with torch.inference_mode(), compute_precision(precision):
            boxes, cls, score = graph(*lifted, *args)
        return boxes, cls, score

    detect.metadata = meta
    return detect


def shard_detector(blob: bytes, devices: Sequence[Union[str, torch.device]]):
    """Data-parallel serving of one ``export_detector`` artifact
    (``shard_detector`` of the JAX package): one replica an entry of
    ``devices`` (``load_detector`` on that device; an entry may repeat, as
    two replicas on one card), each running its slice of every request's
    batch, the slices in order. The artifact must be batch-polymorphic
    (``batch=None``), or exported at the per-replica batch; the batch must
    divide by the replica count. Returns a function with ``detect``'s
    signature whose outputs, concatenated in replica order, lie on the first
    replica's device. The replicas' calls are issued one after another from
    this thread; on distinct cards their kernels run concurrently."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("shard_detector needs at least one device")
    replicas = [load_detector(blob, device=d) for d in devices]

    def detect(rgb, focal, principal_point, patch_size, patch_center, resampling):
        args = (rgb, focal, principal_point, patch_size, patch_center, resampling)
        n = local_batch_size(len(rgb), len(replicas))
        outs = [replica(*[a[i * n : (i + 1) * n] for a in args])
                for i, replica in enumerate(replicas)]
        return tuple(torch.cat([o[k].to(devices[0]) for o in outs])
                     for k in range(len(outs[0])))

    detect.metadata = replicas[0].metadata
    detect.replicas = replicas
    return detect
