"""Programmatic builders for the deep model families.

The port's own copy of ``sparknet_tpu/models/builders.py``: CaffeNet
(the AlexNet variant with pool-before-norm, whose LRNs run K5/K6
unfused), its Flickr-style fine-tune and R-CNN feature variants,
GoogLeNet/Inception-v1 (reference:
``caffe/models/bvlc_googlenet/train_val.prototxt`` — concat, two
auxiliary loss heads at loss_weight 0.3) and ResNet-50 (BatchNorm + Scale
bottleneck residual stacks).  Built with the DSL (``models/dsl.py``), so
each NetParameter equals the JAX builder's; ``models.load_model`` serves
them by name.
"""

from __future__ import annotations

from typing import List

from sparknet_tpu_torch.config.schema import LayerParameter, NetParameter
from sparknet_tpu_torch.models import dsl


def _gauss(std):
    return {"type": "gaussian", "std": std}


def _caffenet_trunk(batch: int, image: int) -> List[LayerParameter]:
    """data..fc7 of CaffeNet (reference:
    ``caffe/models/bvlc_reference_caffenet``) — shared verbatim by the
    R-CNN feature model and the Flickr-style fine-tune variant, whose
    only deltas are the final head (``bvlc_reference_rcnn_ilsvrc13/
    deploy.prototxt``, ``finetune_flickr_style/train_val.prototxt``)."""
    L: List[LayerParameter] = [
        dsl.host_data_layer(
            "data", ["data", "label"], [(batch, 3, image, image), (batch,)]
        )
    ]

    def conv_block(name, bottom, n, k, s=1, p=0, g=1, bias=0.0):
        L.append(
            dsl.conv_layer(
                name,
                bottom,
                num_output=n,
                kernel=k,
                stride=s,
                pad=p,
                group=g,
                weight_filler=_gauss(0.01),
                bias_filler={"type": "constant", "value": bias},
            )
        )
        L.append(dsl.relu_layer(f"relu_{name}", name))
        return name

    t = conv_block("conv1", "data", 96, 11, s=4)
    L.append(dsl.pool_layer("pool1", t, kernel=3, stride=2, method="MAX"))
    L.append(dsl.lrn_layer("norm1", "pool1", local_size=5, alpha=1e-4))
    t = conv_block("conv2", "norm1", 256, 5, p=2, g=2, bias=1.0)
    L.append(dsl.pool_layer("pool2", t, kernel=3, stride=2, method="MAX"))
    L.append(dsl.lrn_layer("norm2", "pool2", local_size=5, alpha=1e-4))
    t = conv_block("conv3", "norm2", 384, 3, p=1)
    t = conv_block("conv4", t, 384, 3, p=1, g=2, bias=1.0)
    t = conv_block("conv5", t, 256, 3, p=1, g=2, bias=1.0)
    L.append(dsl.pool_layer("pool5", t, kernel=3, stride=2, method="MAX"))
    L.append(
        dsl.ip_layer("fc6", "pool5", 4096, weight_filler=_gauss(0.005),
                     bias_filler={"type": "constant", "value": 1.0})
    )
    L.append(dsl.relu_layer("relu6", "fc6"))
    L.append(dsl.dropout_layer("drop6", "fc6", 0.5))
    L.append(
        dsl.ip_layer("fc7", "fc6", 4096, weight_filler=_gauss(0.005),
                     bias_filler={"type": "constant", "value": 1.0})
    )
    L.append(dsl.relu_layer("relu7", "fc7"))
    L.append(dsl.dropout_layer("drop7", "fc7", 0.5))
    return L


def caffenet(batch: int = 256, image: int = 227, classes: int = 1000) -> NetParameter:
    """CaffeNet (reference: ``caffe/models/bvlc_reference_caffenet``):
    AlexNet with pool-before-norm and no grouping changes."""
    L = _caffenet_trunk(batch, image)
    L.append(dsl.ip_layer("fc8", "fc7", classes, weight_filler=_gauss(0.01)))
    L.append(dsl.softmax_loss_layer("loss", "fc8"))
    L.append(dsl.accuracy_layer("accuracy", "fc8", phase="TEST"))
    return dsl.net_param("CaffeNet", *L)


def flickr_style(batch: int = 50, image: int = 227, classes: int = 20) -> NetParameter:
    """Flickr-style fine-tuning variant (reference:
    ``caffe/models/finetune_flickr_style/train_val.prototxt``): CaffeNet
    trunk under the *same layer names* — so a CaffeNet ``.caffemodel``
    warm-starts everything below the head — with a fresh 20-way
    ``fc8_flickr`` at 10x/20x lr_mult so only the new head learns fast."""
    L = _caffenet_trunk(batch, image)
    L.append(
        dsl.ip_layer(
            "fc8_flickr",
            "fc7",
            classes,
            weight_filler=_gauss(0.01),
            lr_mults=(10.0, 20.0),
        )
    )
    L.append(dsl.softmax_loss_layer("loss", "fc8_flickr"))
    L.append(dsl.accuracy_layer("accuracy", "fc8_flickr", phase="TEST"))
    return dsl.net_param("FlickrStyleCaffeNet", *L)


def rcnn_ilsvrc13(batch: int = 10, image: int = 227, classes: int = 200) -> NetParameter:
    """R-CNN ILSVRC-2013 detection feature model (reference:
    ``caffe/models/bvlc_reference_rcnn_ilsvrc13/deploy.prototxt``):
    CaffeNet trunk with a 200-way ``fc-rcnn`` scoring head and *no*
    loss — a deploy/featurization model (drive it through
    ``TorchNet.forward`` taps)."""
    L = _caffenet_trunk(batch, image)
    L.append(
        dsl.ip_layer("fc-rcnn", "fc7", classes, weight_filler=_gauss(0.01))
    )
    net = dsl.net_param("R-CNN-ilsvrc13", *L)
    # deploy models carry no label top: drop it from the data layer
    net.layer[0].top = ["data"]
    net.layer[0].java_data_param.shape = (
        net.layer[0].java_data_param.shape[:1]
    )
    return net


# ---------------------------------------------------------------------------
# GoogLeNet / Inception-v1
# ---------------------------------------------------------------------------

_INCEPTION = {
    # name: (1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj)
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def googlenet(batch: int = 32, image: int = 224, classes: int = 1000) -> NetParameter:
    """Inception-v1 with both auxiliary loss heads at loss_weight 0.3
    (reference: bvlc_googlenet)."""
    L: List[LayerParameter] = [
        dsl.host_data_layer(
            "data", ["data", "label"], [(batch, 3, image, image), (batch,)]
        )
    ]

    def cr(name, bottom, n, k, s=1, p=0):
        L.append(
            dsl.conv_layer(
                name, bottom, num_output=n, kernel=k, stride=s, pad=p,
                weight_filler="xavier",
                bias_filler={"type": "constant", "value": 0.2},
            )
        )
        L.append(dsl.relu_layer(f"relu_{name}", name))
        return name

    t = cr("conv1/7x7_s2", "data", 64, 7, s=2, p=3)
    L.append(dsl.pool_layer("pool1/3x3_s2", t, kernel=3, stride=2, method="MAX"))
    L.append(dsl.lrn_layer("pool1/norm1", "pool1/3x3_s2", local_size=5, alpha=1e-4))
    t = cr("conv2/3x3_reduce", "pool1/norm1", 64, 1)
    t = cr("conv2/3x3", t, 192, 3, p=1)
    L.append(dsl.lrn_layer("conv2/norm2", t, local_size=5, alpha=1e-4))
    L.append(dsl.pool_layer("pool2/3x3_s2", "conv2/norm2", kernel=3, stride=2, method="MAX"))
    t = "pool2/3x3_s2"

    def inception(name, bottom):
        n1, r3, n3, r5, n5, pp = _INCEPTION[name]
        b1 = cr(f"inception_{name}/1x1", bottom, n1, 1)
        b3 = cr(f"inception_{name}/3x3_reduce", bottom, r3, 1)
        b3 = cr(f"inception_{name}/3x3", b3, n3, 3, p=1)
        b5 = cr(f"inception_{name}/5x5_reduce", bottom, r5, 1)
        b5 = cr(f"inception_{name}/5x5", b5, n5, 5, p=2)
        L.append(
            dsl.pool_layer(
                f"inception_{name}/pool", bottom, kernel=3, stride=1, pad=1,
                method="MAX",
            )
        )
        bp = cr(f"inception_{name}/pool_proj", f"inception_{name}/pool", pp, 1)
        L.append(
            dsl.concat_layer(
                f"inception_{name}/output", [b1, b3, b5, bp]
            )
        )
        return f"inception_{name}/output"

    def aux_head(tag, bottom):
        # reference aux classifier: avepool 5x5/3 -> 1x1 conv 128 -> fc 1024
        # -> dropout 0.7 -> fc classes, loss_weight 0.3
        L.append(
            dsl.pool_layer(
                f"{tag}/ave_pool", bottom, kernel=5, stride=3, method="AVE"
            )
        )
        c = cr(f"{tag}/conv", f"{tag}/ave_pool", 128, 1)
        L.append(dsl.ip_layer(f"{tag}/fc", c, 1024, weight_filler="xavier"))
        L.append(dsl.relu_layer(f"{tag}/relu_fc", f"{tag}/fc"))
        L.append(dsl.dropout_layer(f"{tag}/drop_fc", f"{tag}/fc", 0.7))
        L.append(
            dsl.ip_layer(f"{tag}/classifier", f"{tag}/fc", classes,
                         weight_filler="xavier")
        )
        # reference aux heads carry no phase rules (present in both phases)
        loss = dsl.softmax_loss_layer(f"{tag}/loss", f"{tag}/classifier")
        loss.loss_weight = [0.3]
        L.append(loss)

    t = inception("3a", t)
    t = inception("3b", t)
    L.append(dsl.pool_layer("pool3/3x3_s2", t, kernel=3, stride=2, method="MAX"))
    t = inception("4a", "pool3/3x3_s2")
    aux_head("loss1", t)
    t = inception("4b", t)
    t = inception("4c", t)
    t = inception("4d", t)
    aux_head("loss2", t)
    t = inception("4e", t)
    L.append(dsl.pool_layer("pool4/3x3_s2", t, kernel=3, stride=2, method="MAX"))
    t = inception("5a", "pool4/3x3_s2")
    t = inception("5b", t)
    # reference uses kernel 7 stride 1, which at 224 input is exactly global
    L.append(
        dsl.pool_layer(
            "pool5/7x7_s1", t, kernel=7, stride=1, method="AVE",
            global_pooling=True,
        )
    )
    L.append(dsl.dropout_layer("pool5/drop_7x7_s1", "pool5/7x7_s1", 0.4))
    L.append(
        dsl.ip_layer(
            "loss3/classifier", "pool5/7x7_s1", classes, weight_filler="xavier"
        )
    )
    L.append(dsl.softmax_loss_layer("loss3/loss3", "loss3/classifier"))
    L.append(dsl.accuracy_layer("loss3/top-1", "loss3/classifier", phase="TEST"))
    acc5 = dsl.accuracy_layer(
        "loss3/top-5", "loss3/classifier", top_k=5, phase="TEST"
    )
    L.append(acc5)
    return dsl.net_param("GoogLeNet", *L)


# ---------------------------------------------------------------------------
# ResNet-50
# ---------------------------------------------------------------------------


def resnet50(batch: int = 32, image: int = 224, classes: int = 1000) -> NetParameter:
    """ResNet-50 in the Caffe idiom: Convolution (no bias) + BatchNorm +
    Scale + ReLU; bottleneck blocks 1x1/3x3/1x1 with projection shortcuts
    (the deep-net tau-averaging stress model)."""
    L: List[LayerParameter] = [
        dsl.host_data_layer(
            "data", ["data", "label"], [(batch, 3, image, image), (batch,)]
        )
    ]

    def conv_bn(name, bottom, n, k, s=1, p=0, relu=True):
        conv = dsl.conv_layer(
            name, bottom, num_output=n, kernel=k, stride=s, pad=p,
            bias_term=False, weight_filler="msra",
        )
        L.append(conv)
        L.append(dsl.batch_norm_layer(f"bn_{name}", name, top=name))
        L.append(dsl.scale_layer(f"scale_{name}", name))
        if relu:
            L.append(dsl.relu_layer(f"relu_{name}", name))
        return name

    t = conv_bn("conv1", "data", 64, 7, s=2, p=3)
    L.append(dsl.pool_layer("pool1", t, kernel=3, stride=2, method="MAX"))
    t = "pool1"

    def bottleneck(stage, block, bottom, mid, out, stride):
        base = f"res{stage}{block}"
        shortcut = bottom
        first = block == "a"
        if first:
            shortcut = conv_bn(
                f"{base}_branch1", bottom, out, 1, s=stride, relu=False
            )
        b = conv_bn(f"{base}_branch2a", bottom, mid, 1, s=stride)
        b = conv_bn(f"{base}_branch2b", b, mid, 3, p=1)
        b = conv_bn(f"{base}_branch2c", b, out, 1, relu=False)
        L.append(dsl.eltwise_layer(base, [shortcut, b]))
        L.append(dsl.relu_layer(f"relu_{base}", base))
        return base

    stages = [
        (2, 3, 64, 256, 1),
        (3, 4, 128, 512, 2),
        (4, 6, 256, 1024, 2),
        (5, 3, 512, 2048, 2),
    ]
    for stage, blocks, mid, out, stride in stages:
        for i in range(blocks):
            block = chr(ord("a") + i)
            t = bottleneck(stage, block, t, mid, out, stride if i == 0 else 1)

    L.append(
        dsl.pool_layer("pool5", t, kernel=7, stride=1, method="AVE",
                       global_pooling=True)
    )
    L.append(dsl.ip_layer("fc1000", "pool5", classes, weight_filler="xavier"))
    L.append(dsl.softmax_loss_layer("loss", "fc1000"))
    L.append(dsl.accuracy_layer("accuracy", "fc1000", phase="TEST"))
    L.append(dsl.accuracy_layer("accuracy_top5", "fc1000", top_k=5, phase="TEST"))
    return dsl.net_param("ResNet-50", *L)


BUILDERS = {
    "caffenet": caffenet,
    "googlenet": googlenet,
    "resnet50": resnet50,
    "flickr_style": flickr_style,
    "rcnn_ilsvrc13": rcnn_ilsvrc13,
}
