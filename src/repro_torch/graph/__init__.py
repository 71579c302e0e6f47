from repro_torch.graph.topology import resnet50, inception_v3, RESNET50_LAYERS
from repro_torch.graph.etg import build_etg
from repro_torch.graph.executor import GxM
from repro_torch.graph.serving import (CnnInferenceEngine, conv_shapes,
                                       cnn_model_flops,
                                       distinct_conv_signatures,
                                       make_buckets, pick_bucket)

__all__ = ["resnet50", "inception_v3", "RESNET50_LAYERS", "build_etg", "GxM",
           "CnnInferenceEngine", "conv_shapes", "cnn_model_flops",
           "distinct_conv_signatures", "make_buckets", "pick_bucket"]
