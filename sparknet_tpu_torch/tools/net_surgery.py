"""Net surgery: fully-convolutional conversion of InnerProduct layers.

The port's own copy of ``sparknet_tpu/tools/net_surgery.py``.

The reference's ``examples/net_surgery.ipynb`` workflow: cast a trained
classifier's fc layers to convolutions (fc6 -> 6x6 conv, fc7/fc8 -> 1x1)
so the net slides over larger images and emits a dense score map instead
of one vector — weights are *the same numbers reshaped*, because an
InnerProduct over a flattened (C, H, W) bottom computes exactly a VALID
convolution with an (out, C, H, W) kernel at the single aligned
position.

``fc_to_conv`` does the whole operation on (NetParameter, params):
returns a rewritten net and the reshaped params, ready to build a
``TorchNet`` at any input size.  The params may be the port's
tensors (on any device) or numpy arrays; a converted weight is its
source reshaped.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from sparknet_tpu_torch.config.schema import ConvolutionParameter, NetParameter


def fc_to_conv(
    netp: NetParameter,
    blob_shapes: Dict[str, Tuple[int, ...]],
    params: Dict[str, List],
    layer_names: Sequence[str],
    rename: Optional[Dict[str, str]] = None,
) -> Tuple[NetParameter, Dict[str, List]]:
    """Convert the named InnerProduct layers to Convolution layers.

    ``blob_shapes`` is the source net's blob-shape map (it supplies each
    fc bottom's (C, H, W), which becomes the kernel); ``rename``
    optionally maps old -> new layer names (the reference renames
    fc6 -> fc6-conv so ``CopyTrainedLayersFrom`` cannot mis-match
    shapes).  Returns (new NetParameter, new params dict); untouched
    layers keep their parameter tensors by reference."""
    rename = rename or {}
    targets = set(layer_names)
    by_name = {l.name: l for l in netp.layer}
    for name in targets:
        if name not in by_name:
            raise KeyError(f"no layer named {name!r}")
        if by_name[name].type != "InnerProduct":
            raise ValueError(
                f"layer {name!r} is {by_name[name].type}, not InnerProduct"
            )

    new_net = netp.copy()
    new_params: Dict[str, List] = {}
    for name, blobs in params.items():
        if name not in targets:
            new_params[rename.get(name, name)] = list(blobs)

    # renamed layers also rename their top blob when it shares the layer
    # name (the universal Caffe convention and what the reference's
    # surgery prototxt does), so every later bottom/top reference follows
    blob_rename = {
        old: new
        for old, new in rename.items()
        if any(l.name == old and old in l.top for l in netp.layer)
    }
    converted_tops = set()
    for lp in new_net.layer:
        if lp.name in rename:
            lp.name = rename[lp.name]
        lp.bottom = [blob_rename.get(b, b) for b in lp.bottom]
        lp.top = [blob_rename.get(t, t) for t in lp.top]
        if lp.name not in {rename.get(n, n) for n in targets}:
            continue
        old_name = next(
            n for n in targets if rename.get(n, n) == lp.name
        )
        bottom = lp.bottom[0]
        # blob_shapes is keyed by SOURCE names; map a renamed bottom back
        src_bottom = {v: k for k, v in blob_rename.items()}.get(
            bottom, bottom
        )
        bshape = blob_shapes[src_bottom]
        if len(bshape) == 4:
            _, c, kh, kw = bshape
        elif bottom in converted_tops or len(bshape) == 2:
            # bottom was itself converted (or is already flat): 1x1
            c, kh, kw = bshape[1], 1, 1
        else:
            raise ValueError(
                f"cannot infer kernel for {old_name!r} from bottom "
                f"shape {bshape}"
            )
        ip = lp.inner_product_param
        w, *rest = params[old_name]
        if tuple(w.shape) != (ip.num_output, c * kh * kw):
            raise ValueError(
                f"{old_name!r}: weight {w.shape} does not match "
                f"({ip.num_output}, {c}*{kh}*{kw})"
            )
        lp.type = "Convolution"
        lp.inner_product_param = None
        lp.convolution_param = ConvolutionParameter(
            num_output=ip.num_output,
            kernel_size=[kh] if kh == kw else [],
            kernel_h=0 if kh == kw else kh,
            kernel_w=0 if kh == kw else kw,
            bias_term=ip.bias_term,
        )
        new_params[lp.name] = [
            w.reshape(ip.num_output, c, kh, kw)
        ] + list(rest)
        converted_tops.add(lp.top[0])
    return new_net, new_params
