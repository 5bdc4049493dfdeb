"""The port's dry run (launch/{mesh,rules_presets,cells,op_cost,dryrun}.py)
against the reference's tables, and op_cost's counts on hand-computed
programs (the counterparts of tests/test_hlo_cost.py).

* SHAPES, ASSIGNED_ARCHS and shape_applicable equal the reference's.
* rules_for and every preset of resolve_rules give the reference's table
  for every cell; pspec_for gives the reference's PartitionSpec entries for
  every parameter of every cell on both production meshes (the reference
  reads only ``mesh.axis_names``, so a stub mesh serves); accum_steps_for is
  the reference's for every train cell.
* op_cost: one matrix product is exactly 2*M*N*K; a loop of L layers is
  counted L times; reduced yi-34b's train step has dot FLOPs within (0.9,
  3.0) x 6*N*B*S, as tests/test_hlo_cost.py asserts of the reference; TP 1
  gives no collective, and a TP 2 row-parallel projection one all-reduce of
  M*N*bytes per device.
* Full-config cells build and count on ``meta``.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import (  # noqa: E402
    ASSIGNED_ARCHS as J_ARCHS, SHAPES as J_SHAPES, get_config as j_get_config,
    shape_applicable as j_shape_applicable,
)
from repro.launch.cells import accum_steps_for as j_accum_steps_for  # noqa: E402
from repro.launch.rules_presets import resolve_rules as j_resolve_rules  # noqa: E402
from repro.parallel.sharding import pspec_for as j_pspec_for, rules_for as j_rules_for  # noqa: E402

from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, get_config, reduced, shape_applicable  # noqa: E402
from repro_torch.kernels.tp_shard_matmul.ops import tp_shard_matmul  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.launch.cells import accum_steps_for, all_cells  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, mesh_chips  # noqa: E402
from repro_torch.launch.rules_presets import resolve_rules  # noqa: E402
from repro_torch.models.layers import row_parallel  # noqa: E402
from repro_torch.models.model import model_param_defs  # noqa: E402
from repro_torch.models.params import count_params, tree_leaves_with_path, tree_map  # noqa: E402
from repro_torch.parallel.sharding import ShardView, local_shape, make_exec_config, pspec_for, rules_for  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_step import TrainStepConfig, init_opt_state, make_train_step  # noqa: E402

PRESETS = ("default", "no-fsdp", "fsdp-pod", "seq-data", "zero-off", "decode-2d")
META = torch.device("meta")


class _StubMesh:
    """What the reference reads of a mesh: its axis names and sizes."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _meshes():
    return [make_production_mesh(multi_pod=m) for m in (False, True)]


def _table(rules):
    return {k: rules.table[k] for k in rules.table}


def test_shapes_and_archs_match_reference():
    assert ASSIGNED_ARCHS == J_ARCHS
    assert {k: vars(v) for k, v in SHAPES.items()} == {k: vars(v) for k, v in J_SHAPES.items()}
    for arch in ASSIGNED_ARCHS:
        for name, shape in SHAPES.items():
            assert shape_applicable(get_config(arch), shape) == j_shape_applicable(j_get_config(arch), J_SHAPES[name])
    assert [c for c in all_cells() if not c[2]] and len(all_cells()) == 40


def test_meshes():
    single, multi = _meshes()
    assert single == {"data": 16, "model": 16} and mesh_chips(single) == 256
    assert list(multi) == ["pod", "data", "model"] and mesh_chips(multi) == 512


def test_rules_and_presets_match_reference():
    for arch in ASSIGNED_ARCHS:
        for name, shape in SHAPES.items():
            got = rules_for(get_config(arch), shape.kind, shape.seq_len, shape.global_batch)
            want = j_rules_for(j_get_config(arch), shape.kind, shape.seq_len, shape.global_batch)
            assert _table(got) == _table(want), (arch, name)
            for preset in PRESETS:
                assert _table(resolve_rules(preset, arch, name)) == _table(j_resolve_rules(preset, arch, name)), (
                    arch, name, preset)
    with pytest.raises(KeyError):
        resolve_rules("nope", ASSIGNED_ARCHS[0], "train_4k")


def test_pspec_for_matches_reference_on_both_meshes():
    n = 0
    for mesh in _meshes():
        stub = _StubMesh(mesh)
        for arch in ASSIGNED_ARCHS:
            cfg = get_config(arch)
            defs = model_param_defs(cfg, make_exec_config(cfg, 16))
            for name, shape in SHAPES.items():
                for preset in PRESETS:
                    rules, jrules = resolve_rules(preset, arch, name), j_resolve_rules(preset, arch, name)
                    for path, d in tree_leaves_with_path(defs):
                        assert pspec_for(d.axes, rules, mesh) == tuple(j_pspec_for(d.axes, jrules, stub)), (
                            arch, name, preset, path)
                        n += 1
                    axes = ("batch", "seq", "embed")
                    assert pspec_for(axes, rules, mesh) == tuple(j_pspec_for(axes, jrules, stub))
    assert n > 10_000


def test_local_shape():
    mesh = make_production_mesh()
    rules = rules_for(get_config("mistral-large-123b"), "train", 4096, 256)
    assert local_shape((32768, 12288), ("vocab", "embed"), rules, mesh) == (2048, 768)
    assert local_shape((256, 4096), ("batch", "seq"), rules, make_production_mesh(multi_pod=True)) == (8, 4096)
    assert local_shape((5, 7), ("heads", None), rules, mesh) == (1, 7)  # an uneven split pads its last shard


def test_accum_steps_match_reference():
    for mesh in _meshes():
        for arch in ASSIGNED_ARCHS:
            for name, shape in SHAPES.items():
                if shape.kind == "train":
                    assert accum_steps_for(get_config(arch), shape, mesh) == j_accum_steps_for(
                        j_get_config(arch), J_SHAPES[name], _StubMesh(mesh)), (arch, mesh)


def test_one_matmul_is_exactly_2mnk():
    M, K, N = 64, 128, 256
    a, b = torch.empty(M, K, device=META), torch.empty(K, N, device=META)
    _, cost = op_cost.count(lambda: a @ b)
    assert cost.dot_flops == 2 * M * K * N
    assert cost.hbm_bytes == 4 * (M * K + K * N + M * N)
    # the kernel's wrapper takes its plain version on meta tensors and launches nothing
    w = torch.empty(K, 3 * N, dtype=torch.bfloat16, device=META)
    before = tp_shard_matmul.launches
    y, cost = op_cost.count(tp_shard_matmul, a.bfloat16(), w, N, n_out=N, mode="col")
    assert y.shape == (M, N) and y.device == META and y.dtype == torch.bfloat16
    assert cost.dot_flops == 2 * M * K * N and tp_shard_matmul.launches == before
    assert cost.hbm_bytes == 2 * (M * K + K * N) + 4 * M * N  # bf16 operands read, the f32 product written


def test_loop_of_layers_is_counted_per_layer():
    L, M, K = 8, 64, 64
    x, ws = torch.empty(M, K, device=META), torch.empty(L, K, K, device=META)

    def f():
        h = x
        for i in range(L):
            h = torch.tanh(h @ ws[i])
        return h

    _, cost = op_cost.count(f)
    assert cost.dot_flops == L * 2 * M * K * K
    assert cost.ops == 2 * L


def test_nested_loops_multiply():
    L1, L2, M, K = 4, 6, 32, 32
    x, ws = torch.empty(M, K, device=META), torch.empty(L1, L2, K, K, device=META)

    def f():
        h = x
        for i in range(L1):
            for j in range(L2):
                h = h @ ws[i, j]
        return h

    _, cost = op_cost.count(f)
    assert cost.dot_flops == L1 * L2 * 2 * M * K * K


def test_train_flops_close_to_model_flops():
    """The counted dot FLOPs of a real train step are within (0.9, 3.0) of
    the 6*N*D estimate (the recompute adds ~1.3x, attention and the vocab
    the rest), on meta tensors."""
    cfg = reduced(get_config("yi-34b"))
    ec = make_exec_config(cfg, 1)
    B, S = 4, 64
    defs = model_param_defs(cfg, ec)
    params = tree_map(lambda d: torch.empty(d.shape, device=META), defs)
    tcfg = TrainStepConfig(opt=AdamWConfig(), seq_chunk=32, block_q=32, block_k=32)
    step, _ = make_train_step(cfg, ec, params, tcfg)
    opt = init_opt_state(params, tcfg)
    batch = {"tokens": torch.empty(B, S, dtype=torch.int64, device=META),
             "targets": torch.empty(B, S, dtype=torch.int64, device=META)}
    _, cost = op_cost.count(step, params, opt, batch)
    ratio = cost.dot_flops / (6 * count_params(defs) * B * S)
    assert 0.9 < ratio < 3.0, ratio
    assert cost.collective_bytes == 0


@pytest.mark.parametrize("tp", [1, 2])
def test_row_parallel_collective(tp):
    M, K, N = 16, 64, 48
    w = torch.empty(K, N, device=META)
    view = ShardView(tuple([w] * tp), tuple(r * (K // tp) for r in range(tp)), K // tp)
    xs = [torch.empty(M, K // tp, device=META) for _ in range(tp)]
    y, cost = op_cost.count(row_parallel, xs, view, devices=tp)
    assert y.shape == (M, N)
    if tp == 1:
        assert cost.collective_bytes == 0 and cost.collective_count_by_kind == {}
    else:
        assert cost.collective_count_by_kind == {"all-reduce": 1.0}
        assert cost.collective_bytes_by_kind == {"all-reduce": M * N * 4}
    assert cost.dot_flops == 2 * M * K * N / tp


def test_roofline_terms():
    r = op_cost.Roofline(989e12, 3.35e12, 25e9 * 18)
    assert r.compute_s == pytest.approx(1.0) and r.memory_s == pytest.approx(1.0)
    assert r.collective_s == pytest.approx(1.0) and r.bound_s == pytest.approx(1.0)
    d = r.as_dict()
    assert set(d) >= {"flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device", "compute_s",
                      "memory_s", "collective_s", "dominant"}
    assert "not measured" in d["collective_rate"]


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("gemma2-2b", "decode_32k", False),
    ("moonshot-v1-16b-a3b", "decode_32k", False),
    ("h2o-danube-1.8b", "long_500k", True),
])
def test_full_config_cells_count_on_meta(tmp_path, arch, shape, multi_pod):
    info = dryrun.run_cell(arch, shape, multi_pod, str(tmp_path), log=lambda *_: None)
    mesh = "2x16x16" if multi_pod else "16x16"
    with open(tmp_path / f"{arch}__{shape}__{mesh}__default.json") as f:
        assert json.load(f) == json.loads(json.dumps(info))
    assert info["ok"] and info["chips"] == (512 if multi_pod else 256) and info["tp_group"] == 16
    roof = info["roofline"]
    assert roof["flops_per_device"] > 0 and roof["hbm_bytes_per_device"] > 0 and roof["compute_s"] > 0
    assert info["memory"]["argument_bytes"] > 0 and info["memory"]["output_bytes"] > 0
    assert "temp_bytes" not in info["memory"] and "note" in info["memory"] and "count_s" in info
    cfg = get_config(arch)
    counts = info["collectives"]["count_by_kind"]
    if cfg.moe is None:  # each layer's two row-parallel projections and the embedding: one all-reduce each
        assert counts == {"all-reduce": 2 * cfg.num_layers + 1}
    else:  # decode takes the MoE decode path: its ranks sum their experts' outputs
        assert counts["all-reduce"] == 2 * cfg.num_layers + 1


def test_dryrun_main_skips_and_filters(tmp_path, capsys):
    assert dryrun.main(["--arch", "yi-34b", "--shape", "long_500k", "--out", str(tmp_path)]) == 0
    assert "SKIP yi-34b x long_500k" in capsys.readouterr().out
