"""The port's analysis tools against the JAX tools, on the CPU.

- ``get_flops``: its parameter count equals JAX's (the ``params`` leaves of
  ``jax.eval_shape`` of ``model.init``, as ``tools/get_flops.py`` sums
  them) on Tiny_L, Tiny_Waymo_L and a tiny LiDAR + camera config; its
  per-level sparse FLOPs equal 2 x hits x C_in x C_out counted on JAX's own
  rulebooks (``focalformer3d_tpu/ops/sparse_conv.build_conv_rules`` on
  JAX's voxels) integer for integer, at capacities that no level
  overflows; the engines ``plain``, ``cuda``, ``cuda_mxu`` and
  ``cuda_zrun`` count the same on the levels they share; what runs inside
  a conv or K2 never reaches the count; and its dense FLOPs of SECOND +
  SECONDFPN lie within ``XLA_BAND`` of XLA's cost analysis of JAX's same
  modules.
- ``analyze_logs``: ``parse`` equals the JAX tool's record for record on a
  log the port's train CLI wrote (two synthetic Tiny_L steps, both its
  JSON records and its printed lines) and on a hand-written text log with
  ``inf`` and exponents; ``main`` prints what the JAX tool prints, byte for
  byte; ``--plot-out`` writes a PNG that reads back.
- ``browse_dataset``: ``bev_geometry`` equals what JAX's ``render_bev``
  hands matplotlib (a stub records it, so no matplotlib is needed) within
  1e-12; its PNG decodes (``zlib`` and ``struct`` here, not the port's
  reader) to the stated size with a red pixel at every corner in range and
  a non-white pixel at every point in range; on a nuScenes directory it
  draws the sample the JAX tool draws, bit for bit, under both pipelines.
"""
import contextlib
import dataclasses
import io
import json
import struct
import sys
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.models.detector import FocalFormer3D as JaxFF3D
from focalformer3d_tpu.models.detector import preprocess_points as jax_prep
from focalformer3d_tpu.ops import sparse_conv as jsc
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.data import synthetic
from focalformer3d_tpu_torch.models import sparse_encoder as se
from focalformer3d_tpu_torch.models.detector import FocalFormer3D
from focalformer3d_tpu_torch.tools import analyze_logs, browse_dataset
from focalformer3d_tpu_torch.tools import get_flops as gf
from focalformer3d_tpu_torch.tools import train as train_cli
from focalformer3d_tpu_torch.utils import png
from test_camera import tiny_lc_config
from test_torch_dataset_cli import write_tiny
from tools import analyze_logs as jax_logs
from tools import browse_dataset as jax_browse

torch.set_num_threads(2)
CPU = torch.device("cpu")
N_POINTS = 3000
# capacities that hold every level of Tiny_L's 3000-point scan
CAPS = dict(capacities=(2048, 1024, 1024, 512), out_capacity=512)
ENGINES = ("plain", "cuda", "cuda_mxu", "cuda_zrun")
# the port's dense FLOPs of SECOND + SECONDFPN over XLA's on a 16 x 16 map
# (measured 1.0897; test_dense_flops_within_band_of_xla says why)
XLA_BAND = (1.08, 1.10)


def _tiny(name="Tiny_L", **kw):
    return dataclasses.replace(tconfigs.get_config(name)["model"], **kw)


def _jax_params(jcfg, batch):
    """The JAX tool's parameter count (tools/get_flops.py:50-60)."""
    model = JaxFF3D(jcfg)
    img = ({k: jnp.asarray(batch[k]) for k in gf.IMG_KEYS}
           if jcfg.input_img else None)
    variables = jax.eval_shape(
        lambda p, m, i: model.init({"params": jax.random.PRNGKey(0)},
                                   jax_prep(jcfg, p, m), i, False),
        jnp.asarray(batch["points"]), jnp.asarray(batch["points_mask"]), img)
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(variables["params"]))


def _to_port(j):
    d = dataclasses.asdict(j)
    return tconfigs.DetectorConfig(**{
        **d, "voxel": tconfigs.VoxelConfig(**d["voxel"]),
        "lss": tconfigs.LSSConfig(**d["lss"]),
        "decoder": tconfigs.FocalDecoderConfig(**d["decoder"])})


def _tiny_lc():
    """(JAX config, port config): the tiny LiDAR + camera config of
    ``tests/test_camera.py`` on ResNet-50, with two decoder layers as
    every named config with RoI features has. (With one, the port's model
    still holds the RoI MLP, 15 520 parameters at this width, that no
    forward calls; flax creates a parameter only when its module is
    called, so JAX's count leaves it out.)"""
    jm = dataclasses.replace(
        tiny_lc_config(), img_backbone_depth=50,
        decoder=dataclasses.replace(tiny_lc_config().decoder,
                                    num_decoder_layers=2))
    return jm, _to_port(jm)


@pytest.mark.parametrize("name", ["Tiny_L", "Tiny_Waymo_L", "Tiny_LC"])
def test_params_equal_jax(name):
    if name == "Tiny_LC":
        jcfg, tcfg = _tiny_lc()
    else:
        jcfg = jax_get_config(name)["model"]
        tcfg = tconfigs.get_config(name)["model"]
    batch = synthetic.make_batch(
        np.random.RandomState(0), batch_size=1, n_points=800, n_boxes=3,
        max_gts=8, num_classes=jcfg.decoder.num_classes,
        pc_range=jcfg.voxel.point_cloud_range, with_images=jcfg.input_img,
        n_cams=2, img_hw=jcfg.lss.img_scale)
    got = gf.count_params(FocalFormer3D(tcfg))
    assert got == _jax_params(jcfg, batch) and got > 0


def _count(cfg, seed=5):
    model = gf.build_model(cfg, CPU)
    rng = np.random.RandomState(seed)
    b = synthetic.make_batch(rng, batch_size=1, n_points=N_POINTS,
                             n_boxes=4, max_gts=8,
                             num_classes=cfg.decoder.num_classes,
                             pc_range=cfg.voxel.point_cloud_range,
                             mode="radial")
    pts, mask = (torch.from_numpy(b["points"]),
                 torch.from_numpy(b["points_mask"]))
    return gf.count_forward(model, cfg, pts, mask, None), b


@pytest.fixture(scope="module")
def counts():
    return {e: _count(_tiny(sparse_engine=e, **CAPS)) for e in ENGINES}


def _hits(rules, valid, v_in):
    return int((np.asarray(rules) < v_in)[:, np.asarray(valid)].sum())


def test_sparse_flops_equal_jax_rulebooks(counts):
    """L0 and L1 (the sparse levels at eval) from JAX's voxels and
    rulebooks: subm rules on each level's set, the strided rulebook onto
    ``build_downsample``'s output set."""
    rep, batch = counts["plain"]
    tcfg = _tiny(**CAPS)
    jcfg = dataclasses.replace(jax_get_config("Tiny_L")["model"], **CAPS)
    vox = jax_prep(jcfg, jnp.asarray(batch["points"]),
                   jnp.asarray(batch["points_mask"]))
    coords, valid = vox["coords"][0], vox["voxel_mask"][0]
    shape = tuple(jcfg.sparse_shape)
    table = jsc.build_table(coords, valid, shape)
    positions = False
    c = tcfg.voxel_feature_dim
    want = {}
    for lv in range(tcfg.sparse_dense_from_eval):
        v_in = coords.shape[0]
        subm = jsc.build_conv_rules(table, shape, coords, valid, 3, 1, 1,
                                    use_positions=positions)
        pad = jcfg.down_paddings[lv]
        oc, ov, oshape, overflow, ometa = jsc.build_downsample(
            coords, valid, shape, 3, 2, pad, jcfg.capacities[lv + 1])
        assert int(overflow) == 0
        down = jsc.build_conv_rules(table, shape, oc, ov, 3, 2, pad,
                                    use_positions=positions)
        h_subm, h_down = _hits(subm, valid, v_in), _hits(down, ov, v_in)
        flops = 0
        if lv == 0:  # conv_input
            flops += 2 * h_subm * c * jcfg.encoder_channels[0][0]
            c = jcfg.encoder_channels[0][0]
        blocks = jcfg.encoder_channels[lv]
        for out in blocks[:-1]:  # the basic blocks: two subm convs each
            flops += 2 * 2 * h_subm * out * out
        flops += 2 * h_down * c * blocks[-1]
        c = blocks[-1]
        want[f"L{lv}"] = flops
        coords, valid, shape = oc, ov, tuple(oshape)
        table = jsc.table_from_meta(oc, ov, ometa)
        positions = True
    got = {lv: r["flops"] for lv, r in rep["sparse_conv"]["levels"].items()}
    assert got == want and all(v > 0 for v in want.values())


def test_sparse_count_equal_on_every_engine(counts):
    ref = counts["plain"][0]["sparse_conv"]["levels"]
    assert sorted(ref) == ["L0", "L1"]
    for engine in ENGINES:
        rep = counts[engine][0]
        levels = rep["sparse_conv"]["levels"]
        for lv in ("L0", "L1"):
            assert levels[lv] == ref[lv], (engine, lv)
    mxu = counts["cuda_mxu"][0]
    assert sorted(mxu["sparse_conv"]["levels"]) == ["L0", "L1", "L2", "L3",
                                                    "conv_out"]
    assert mxu["plan_rules"]["calls"] == 8 and mxu["plan_rules"]["bytes"] > 0
    assert mxu["sparse_conv"]["convs"] == 21
    assert counts["cuda"][0]["sparse_conv"]["convs"] == 11


@pytest.mark.parametrize("engine", ["cuda", "cuda_mxu"])
def test_kernels_run_outside_the_count(counts, engine, monkeypatch):
    """The whole count stays as it was when the conv and K2 compute
    their function another way with more ops (the plain version twice and
    a float64 product, which a counting mode would see: the last check)."""
    extra = []

    def work(x):
        y = torch.einsum("ij,kj->ik", x.double(), x.double())
        extra.append(y.sum())

    def conv(x, rules, w, valid, bias=None):
        work(w.reshape(-1, w.shape[-1]).float())
        se.apply_conv_plain(x.float(), rules, w.float(), valid, bias,
                            torch.float32)
        return se.apply_conv_plain(x.float(), rules, w.float(), valid, bias,
                                   torch.float32)

    k2 = se.plan_rules

    def plan_rules(meta, colz, *args):
        work(meta.float().reshape(-1, 1)[:64])
        k2(meta, colz, *args)
        return k2(meta, colz, *args)

    monkeypatch.setattr(se, "sparse_conv", conv)
    monkeypatch.setattr(se, "plan_rules", plan_rules)
    rep, _ = _count(_tiny(sparse_engine=engine, **CAPS))
    assert extra, "the replacements did not run"
    ref = counts[engine][0]
    assert rep == ref
    with gf.Count() as count:
        work(torch.ones(4, 3))
    assert count.report()["dense"]["flops"] == 2 * 4 * 4 * 3


def _second_flops(cfg, n, cin):
    """(whole-window, in-map) FLOPs of SECOND + SECONDFPN's convolutions on
    an n x n map: two per multiply-add over every tap of each window, and
    over the taps that land inside the map alone (what XLA counts)."""
    def taps(size, k, stride, pad):
        out = (size + 2 * pad - k) // stride + 1
        inside = sum(0 <= o * stride - pad + t < size
                     for o in range(out) for t in range(k))
        return out, inside

    whole = inside = 0
    h, c = n, cin
    for ch, layers, stride in zip(cfg.second_channels, cfg.second_layers,
                                  (1, 2)):
        for j in range(layers + 1):
            out, t = taps(h, 3, stride if j == 0 else 1, 1)
            whole += 2 * c * ch * 9 * out * out
            inside += 2 * c * ch * t * t
            h, c = out, ch
    # SECONDFPN: a 1x1 conv on the first map, a 2x2 stride-2 transposed
    # conv on the second (every tap of both lands inside)
    up = (2 * cfg.second_channels[0] * cfg.fpn_channels[0] * n * n
          + 2 * cfg.second_channels[1] * cfg.fpn_channels[1] * 4 * h * h)
    return whole + up, inside + up


def test_dense_flops_within_band_of_xla():
    """FlopCounterMode counts every tap of a padded window; XLA's cost
    analysis counts only the taps that land inside the map, and adds one
    FLOP per element of the batch-norm affine, the ReLUs and the like. On
    a 16 x 16 map a 3x3 window's in-map share is (46/48)^2 at stride 1 and
    (23/24)^2 at stride 2, so the port's figure lies above XLA's:
    ``XLA_BAND`` is its measured ratio 1.0897 with a margin; it tends to 1
    as the map grows (1.039 at 32 x 32, 1.20 at 8 x 8)."""
    from focalformer3d_tpu.models.second import SECOND as JSECOND
    from focalformer3d_tpu.models.second import SECONDFPN as JFPN
    from focalformer3d_tpu_torch.models.second import SECOND, SECONDFPN
    from flax import linen as nn

    cfg = _tiny()
    n, cin = 16, 64
    x = np.random.RandomState(0).randn(1, n, n, cin).astype(np.float32)

    class Both(nn.Module):
        @nn.compact
        def __call__(self, v):
            sec = JSECOND(out_channels=cfg.second_channels,
                          layer_nums=cfg.second_layers, dtype=jnp.float32)
            return JFPN(out_channels=cfg.fpn_channels,
                        dtype=jnp.float32)(sec(v, False), False)

    mod = Both()
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    cost = jax.jit(mod.apply).lower(variables, jnp.asarray(x)).compile() \
        .cost_analysis()
    xla = (cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"]
    sec = SECOND(cin, cfg.second_channels, cfg.second_layers).eval()
    fpn = SECONDFPN(cfg.second_channels, cfg.fpn_channels).eval()
    with torch.no_grad(), gf.Count() as count:
        out = fpn(sec(torch.from_numpy(x)))
    assert out.shape == (1, n, n, sum(cfg.fpn_channels))
    got = count.report()["dense"]["flops"]
    whole, inside = _second_flops(cfg, n, cin)
    assert got == whole
    # what XLA adds to the in-map products: under 1% of its count
    assert 0 < xla - inside < 0.01 * xla
    assert XLA_BAND[0] <= got / xla <= XLA_BAND[1], got / xla


def test_get_flops_main_prints_the_jax_lines(capsys):
    rep = gf.main(["Tiny_L", "--device", "cpu", "--n-points", "2000",
                   "--engine", "cuda_zrun", "--repeat", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [x.split(":")[0] for x in lines[:5]] == [
        "config", "params", "forward flops", "bytes accessed",
        "arithmetic intensity"]
    assert lines[2] == f"forward flops: {rep['flops'] / 1e9:.2f} GFLOPs"
    assert json.loads(lines[5]) == json.loads(json.dumps(rep))
    assert rep["flops"] == rep["dense"]["flops"] + rep["sparse_conv"]["flops"]
    assert rep["forward_ms"] > 0 and rep["params"] == 692476


def test_get_flops_needs_a_card_without_cpu_flag(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        gf.main(["Tiny_L"])


# ---------------------------------------------------------------- logs
HAND_LOG = """\
2026-01-01 start
epoch 0 iter 1 (1.25s/it) loss=3.5000 grad_norm=inf lr=1.0e-04
epoch 0 iter 2 (0.75s/it) loss=2.2500 grad_norm=12.5000 lr=1.2e-04
not a log line
{"mode": "epoch", "epoch": 0, "iters": 2}
{broken json
epoch 1 iter 1 (0.50s/it) loss=-inf grad_norm=3.0000 lr=1.5e-04
"""


@pytest.fixture(scope="module")
def port_logs(tmp_path_factory):
    """The train CLI's JSON log and its printed lines (the text log) of
    two synthetic Tiny_L steps at ``--log-interval 1``."""
    work = tmp_path_factory.mktemp("logs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["Tiny_L", "--synthetic", "--device", "cpu",
                        "--epochs", "1", "--iters-per-epoch", "2",
                        "--batch-size", "1", "--log-interval", "1",
                        "--work-dir", str(work), "--no-tensorboard"])
    text = work / "train.log"
    text.write_text(buf.getvalue())
    hand = work / "hand.log"
    hand.write_text(HAND_LOG)
    return {"jsonl": work / "train_log.jsonl", "text": text, "hand": hand}


@pytest.mark.parametrize("kind", ["jsonl", "text", "hand"])
def test_parse_equals_jax(port_logs, kind):
    got = analyze_logs.parse(str(port_logs[kind]))
    assert got == jax_logs.parse(str(port_logs[kind]))
    assert len(got) == {"jsonl": 2, "text": 2, "hand": 3}[kind]


@pytest.mark.parametrize("keys", [["loss"], ["loss", "grad_norm", "lr"]])
def test_main_prints_as_jax(port_logs, keys, capsys, monkeypatch):
    paths = [str(port_logs[k]) for k in ("jsonl", "text", "hand")]
    analyze_logs.main(paths + ["--keys", *keys])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["analyze_logs.py", *paths, "--keys",
                                      *keys])
    jax_logs.main()
    assert got == capsys.readouterr().out and got.count("log points") == 3


def test_plot_out_writes_a_png(port_logs, tmp_path, capsys):
    out = tmp_path / "curves.png"
    analyze_logs.main([str(port_logs["hand"]), "--keys", "loss",
                       "grad_norm", "--plot-out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2] == "  colours: loss blue, grad_norm orange"
    assert lines[-1] == f"wrote {out}"
    rgb = _decode(out)
    assert rgb.shape == (analyze_logs.PLOT_SIZE[1],
                         analyze_logs.PLOT_SIZE[0], 3)
    for name in ("blue", "orange"):
        colour = dict(png.PALETTE)[name]
        assert (rgb == colour).all(-1).sum() > 10, name


# -------------------------------------------------------------- browse
def _decode(path):
    """An 8-bit RGB PNG with filter-0 rows, by zlib and struct alone."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, size = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == \
            zlib.crc32(kind + body)
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            assert (depth, colour) == (8, 2)
            size = (w, h)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture
def stub_pyplot(monkeypatch):
    """matplotlib replaced by a stub that records ``ax.scatter`` and
    ``ax.plot``."""
    calls = {"scatter": [], "plot": []}

    class Ax:
        def scatter(self, x, y, **kw):
            calls["scatter"].append((np.array(x), np.array(y)))

        def plot(self, x, y, *a, **kw):
            calls["plot"].append((np.array(x), np.array(y)))

        def __getattr__(self, name):
            return lambda *a, **kw: None

    class Fig:
        def savefig(self, *a, **kw):
            pass

    plt = types.ModuleType("matplotlib.pyplot")
    plt.subplots = lambda *a, **kw: (Fig(), Ax())
    plt.close = lambda *a: None
    mpl = types.ModuleType("matplotlib")
    mpl.use = lambda *a, **kw: None
    mpl.pyplot = plt
    monkeypatch.setitem(sys.modules, "matplotlib", mpl)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", plt)
    return calls


@pytest.mark.parametrize("index", [0, 7])
def test_geometry_equals_render_bev(stub_pyplot, index, tmp_path):
    pts, boxes, _ = synthetic.make_scene(np.random.RandomState(index))
    jax_browse.render_bev(pts, boxes, str(tmp_path / "j.png"))
    xy, corners = browse_dataset.bev_geometry(pts, boxes)
    (sx, sy), = stub_pyplot["scatter"]
    np.testing.assert_allclose(xy, np.stack([sx, sy], 1).astype(np.float64),
                               rtol=0, atol=1e-12)
    assert len(stub_pyplot["plot"]) == len(boxes) == len(corners) > 0
    for got, (px, py) in zip(corners, stub_pyplot["plot"]):
        np.testing.assert_allclose(got, np.stack([px, py], 1), rtol=0,
                                   atol=1e-12)


def _check_image(path, points, boxes, size):
    rgb = _decode(path)
    assert rgb.shape == (size, size, 3)
    canvas = png.Canvas(size, size, (-54, 54), (-54, 54))
    xy, corners = browse_dataset.bev_geometry(points, boxes)
    r, c = canvas.to_pixel(corners.reshape(-1, 2))
    keep = canvas.inside(r, c)
    assert keep.any()
    assert (rgb[r[keep], c[keep]] == png.RED).all()
    r, c = canvas.to_pixel(xy)
    keep = canvas.inside(r, c)
    assert keep.sum() > 100
    assert (rgb[r[keep], c[keep]] != png.WHITE).any(-1).all()
    return rgb


def test_synthetic_png(tmp_path, capsys):
    out = tmp_path / "s.png"
    browse_dataset.main(["--synthetic", "--index", "3", "--out", str(out)])
    assert capsys.readouterr().out == f"wrote {out}\n"
    pts, boxes, _ = synthetic.make_scene(np.random.RandomState(3))
    rgb = _check_image(out, pts, boxes, browse_dataset.SIZE)
    assert (rgb == png.GRAY).all(-1).sum() > 100
    np.testing.assert_array_equal(rgb, png.read_png(str(out)))


@pytest.fixture(scope="module")
def nusc_dir(tmp_path_factory):
    return write_tiny(tmp_path_factory.mktemp("nuscenes"), samples=2)


@pytest.mark.parametrize("train", [False, True])
def test_samples_equal_jax_tool(nusc_dir, train, tmp_path, monkeypatch):
    flags = ["--data-root", str(nusc_dir), "--index", "1",
             "--out", str(tmp_path / "n.png")]
    flags += ["--train-pipeline"] if train else []
    drawn = []
    monkeypatch.setattr(jax_browse, "render_bev",
                        lambda p, b, out: drawn.append((p, b)))
    monkeypatch.setattr(sys, "argv", ["browse_dataset.py", *flags])
    jax_browse.main()
    (jpts, jboxes), = drawn
    pts, boxes = browse_dataset.load_sample(browse_dataset.parse_args(flags))
    for got, ref in ((pts, jpts), (boxes, jboxes)):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert len(boxes) > 0
    with contextlib.redirect_stdout(io.StringIO()):
        browse_dataset.main(flags)
    _check_image(tmp_path / "n.png", pts, boxes, browse_dataset.SIZE)


def test_line_pixels_are_bresenhams():
    r, c = png.line_pixels(0, 0, 3, 7)
    assert list(zip(r, c)) == [(0, 0), (0, 1), (1, 2), (1, 3), (2, 4),
                               (2, 5), (3, 6), (3, 7)]
    r, c = png.line_pixels(5, 2, 5, 2)
    assert list(zip(r, c)) == [(5, 2)]
    r, c = png.line_pixels(4, 4, 0, 2)  # halves round away from the start
    assert list(zip(r, c)) == [(4, 4), (3, 3), (2, 3), (1, 2), (0, 2)]
    r, c = png.line_pixels(1 << 21, 0, 1 << 22, 5)
    assert len(r) == 0


def _report(ops, flops=10, nbytes=None):
    return {"flops": flops, "bytes": sum(r[2] for r in ops.values())
            if nbytes is None else nbytes, "dense": {"by_op": ops},
            "sparse_conv": {"flops": 0}, "plan_rules": {"calls": 0}}


def test_card_count_against_cpu_names_what_differs():
    """``get_flops.count_differs``: the CPU's count may hold
    ``F.one_hot``'s range check beyond the card's, and nothing else."""
    card = {"aten.add": [3, 0, 96], "aten.mm": [1, 10, 48]}
    check = {"aten.min": [2, 0, 20], "aten.max": [2, 0, 20],
             "aten._local_scalar_dense": [4, 0, 32]}
    differ, only = gf.count_differs(_report(card), _report({**card, **check}))
    assert differ == [] and only == check
    assert gf.count_differs(_report(card), _report(card)) == ([], {})
    half = {**check, "aten._local_scalar_dense": [2, 0, 16]}
    differ, _ = gf.count_differs(_report(card), _report({**card, **half}))
    assert len(differ) == 1 and "not one_hot's" in differ[0]
    other = {**card, "aten.add": [4, 0, 128]}
    differ, _ = gf.count_differs(_report(card), _report(other))
    assert differ == ["bytes", "aten.add [3, 0, 96] against [4, 0, 128]"]
    differ, _ = gf.count_differs(_report(card), _report(card, flops=11))
    assert differ == ["flops"]
