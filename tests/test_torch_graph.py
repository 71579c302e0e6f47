"""The port's graph front end (topology, fusion, ETG, shape walk) against
the JAX package's: same task names, ops, inputs, fused lists, kernel ids,
chains, stats and conv shapes."""
import pytest

from repro.core import fusion as jax_fusion
from repro.graph import etg as jax_etg
from repro.graph import serving as jax_serving
from repro.graph import topology as jax_topology
from repro_torch.core import fusion
from repro_torch.core.conv import lane_ok
from repro_torch.graph import etg, serving, topology

NETS = {
    "resnet50": lambda m: m.resnet50(),
    "resnet50_reduced": lambda m: m.resnet50(10, stages=(1, 1, 1, 1)),
    "inception_v3": lambda m: m.inception_v3(),
}


def _nodes(nodes):
    return [(n.name, n.op, list(n.inputs), n.attrs, list(n.fused))
            for n in nodes]


def _chains(chains):
    return [(c.names, c.rs, c.halo_growth) for c in chains]


@pytest.mark.parametrize("net", NETS)
def test_topology_matches(net):
    assert _nodes(NETS[net](topology)) == _nodes(NETS[net](jax_topology))


def test_resnet50_layer_table_matches():
    assert topology.RESNET50_LAYERS == jax_topology.RESNET50_LAYERS


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("net", NETS)
def test_build_etg_matches(net, fuse):
    ours = etg.build_etg(NETS[net](topology), fuse=fuse)
    ref = jax_etg.build_etg(NETS[net](jax_topology), fuse=fuse)
    assert _nodes(ours.tasks) == _nodes(ref.tasks)
    assert ours.kernel_cache == ref.kernel_cache
    assert ours.stats == ref.stats
    assert _chains(ours.chains) == _chains(ref.chains)


@pytest.mark.parametrize("net", NETS)
def test_fusion_passes_match(net):
    enl = etg.extend_nl(NETS[net](topology))
    jenl = jax_etg.extend_nl(NETS[net](jax_topology))
    assert _nodes(enl) == _nodes(jenl)
    fused = fusion.fuse_network(enl)
    jfused = jax_fusion.fuse_network(jenl)
    assert _nodes(fused) == _nodes(jfused)
    assert fusion.fusion_stats(enl, fused) == \
        jax_fusion.fusion_stats(jenl, jfused)
    tasks, jtasks = etg.toposort(fused), jax_etg.toposort(jfused)
    assert _nodes(tasks) == _nodes(jtasks)
    assert _chains(fusion.detect_chains(tasks)) == \
        _chains(jax_fusion.detect_chains(jtasks))
    assert fusion.chain_band_rows(((3, 1, 1), (1, 2, 0)), 4) == \
        jax_fusion.chain_band_rows(((3, 1, 1), (1, 2, 0)), 4)


@pytest.mark.parametrize("net,hw", [("resnet50", (224, 224)),
                                    ("resnet50_reduced", (32, 32)),
                                    ("inception_v3", (48, 48))])
def test_conv_shapes_and_flops_match(net, hw):
    ours = etg.build_etg(NETS[net](topology))
    ref = jax_etg.build_etg(NETS[net](jax_topology))
    shapes = serving.conv_shapes(ours, hw)
    assert shapes == jax_serving.conv_shapes(ref, hw)
    assert serving.distinct_conv_signatures(shapes) == \
        jax_serving.distinct_conv_signatures(shapes)
    assert serving.cnn_model_flops(ours, hw, 3) == \
        jax_serving.cnn_model_flops(ref, hw, 3)


def test_resnet50_kernel_path_counts():
    """Full ResNet-50 at 224x224: 53 convs, 52 of them on K1 (all but the
    C=3 stem), 8.18 GFLOP per image."""
    g = etg.build_etg(topology.resnet50())
    shapes = serving.conv_shapes(g, (224, 224))
    assert len(shapes) == 53
    assert sum(lane_ok(s["c"], s["k"]) for s in shapes) == 52
    assert [s["name"] for s in shapes if not lane_ok(s["c"], s["k"])] == \
        ["conv1"]
    fused = [tuple(k for k, _ in t.fused) for t in g.tasks if t.op == "conv"]
    assert fused.count(("bn", "relu")) == 33      # 32 on K1 + the stem
    assert fused.count(("bn", "add", "relu")) == 16
    assert fused.count(("bn",)) == 4
    assert round(serving.cnn_model_flops(g, (224, 224), 1) / 1e9, 2) == 8.18
