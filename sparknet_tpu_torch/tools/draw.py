"""Net visualization: NetParameter -> graphviz dot text.

The port's own copy of ``sparknet_tpu/tools/draw.py``.

Reference role: ``caffe/python/caffe/draw.py:1-213`` (``draw_net_to_file``)
— there it renders through pydot/graphviz; here the dot source is emitted
directly (no third-party dependency; feed the file to ``dot -Tpng`` to
render).  Same visual grammar: one record node per layer colored by type,
octagon nodes per blob, edges labeled with the producing layer's output
size, in-place neuron layers (bottom == top) highlighted green.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from sparknet_tpu_torch.config.schema import LayerParameter, NetParameter

# fill colors by layer type (draw.py choose_color_by_layertype)
_COLORS = {
    "Convolution": "#FF5050",
    "Deconvolution": "#FF5050",
    "Pooling": "#FF9900",
    "InnerProduct": "#CC33FF",
    "Attention": "#33CCCC",
}
_DEFAULT_COLOR = "#6495ED"
_NEURON_COLOR = "#90EE90"
_BLOB_STYLE = 'shape=octagon, fillcolor="#E0E0E0", style=filled'


def _first(lst, default):
    return lst[0] if lst else default


def layer_label(layer: LayerParameter, sep: str) -> str:
    """Node label; conv/pool carry kernel/stride/pad like the reference."""
    if layer.type in ("Convolution", "Deconvolution"):
        p = layer.convolution_param
        if p is not None:
            return sep.join([
                layer.name, f"({layer.type})",
                f"kernel size: {_first(p.kernel_size, 1)}",
                f"stride: {_first(p.stride, 1)}",
                f"pad: {_first(p.pad, 0)}",
            ])
    if layer.type == "Pooling" and layer.pooling_param is not None:
        p = layer.pooling_param
        return sep.join([
            layer.name, f"({p.pool} {layer.type})",
            f"kernel size: {p.kernel_size}",
            f"stride: {p.stride}",
            f"pad: {p.pad}",
        ])
    return sep.join([layer.name, f"({layer.type})"])


def edge_label(layer: LayerParameter) -> str:
    """Output-size label on layer->top edges (draw.py get_edge_label)."""
    if layer.type == "Data" and layer.data_param is not None:
        return f"Batch {layer.data_param.batch_size}"
    if (
        layer.type in ("Convolution", "Deconvolution")
        and layer.convolution_param is not None
    ):
        return str(layer.convolution_param.num_output)
    if layer.type == "InnerProduct" and layer.inner_product_param is not None:
        return str(layer.inner_product_param.num_output)
    return ""


def _q(s: str) -> str:
    return '"' + s.replace('"', '\\"') + '"'


def net_to_dot(
    netp: NetParameter,
    rankdir: str = "LR",
    label_edges: bool = True,
    phase: Optional[str] = None,
) -> str:
    """NetParameter -> dot source.  ``phase`` pre-filters with the same
    NetStateRule pass the net compiler uses (``graph.filter_net``)."""
    if phase is not None:
        from sparknet_tpu_torch.config.schema import NetState
        from sparknet_tpu_torch.graph import filter_net

        netp = filter_net(netp, NetState(phase=phase))
    # vertical layouts have free horizontal space -> spaces; horizontal
    # layouts stack the label lines (draw.py get_layer_label)
    sep = " " if rankdir in ("TB", "BT") else "\\n"
    lines: List[str] = [
        f"digraph {_q(netp.name or 'net')} {{",
        f"  rankdir={rankdir};",
        "  node [shape=record];",
    ]
    blob_nodes: Dict[str, None] = {}
    node_lines: List[str] = []
    edge_lines: List[str] = []
    for layer in netp.layer:
        node = f"{layer.name}_{layer.type}"
        in_place = (
            len(layer.bottom) == 1
            and len(layer.top) == 1
            and layer.bottom[0] == layer.top[0]
        )
        color = (
            _NEURON_COLOR if in_place
            else _COLORS.get(layer.type, _DEFAULT_COLOR)
        )
        node_lines.append(
            f"  {_q(node)} [label={_q(layer_label(layer, sep))}, "
            f'fillcolor="{color}", style=filled];'
        )
        for b in layer.bottom:
            blob_nodes.setdefault(b)
            edge_lines.append(f"  {_q(b + '_blob')} -> {_q(node)};")
        for t in layer.top:
            blob_nodes.setdefault(t)
            lbl = edge_label(layer) if label_edges else ""
            attr = f" [label={_q(lbl)}]" if lbl else ""
            edge_lines.append(f"  {_q(node)} -> {_q(t + '_blob')}{attr};")
    for b in blob_nodes:
        node_lines.append(f"  {_q(b + '_blob')} [label={_q(b)}, {_BLOB_STYLE}];")
    lines += node_lines + edge_lines + ["}"]
    return "\n".join(lines) + "\n"


def draw_net_to_file(
    netp: NetParameter,
    filename: str,
    rankdir: str = "LR",
    label_edges: bool = True,
    phase: Optional[str] = None,
) -> None:
    """Write dot source to ``filename`` (draw.py draw_net_to_file's '.raw'
    mode; run graphviz on the result for an image)."""
    with open(filename, "w") as f:
        f.write(net_to_dot(netp, rankdir, label_edges, phase))
