"""The frame's accessors in the port against vaex_tpu: df.geo and df.astro
(virtual columns of device functions, also held to the matrix oracles of
vaex_tpu's astro tests), struct_get / struct_project, df.viz's grids and
drawings, and the command line through ``main([...])``."""

import json
import sys

import numpy as np
import numpy.testing as npt
import pytest

import vaex_tpu
import vaex_tpu_torch
from vaex_tpu_torch import settings
from vaex_tpu_torch.scopes import expression_is_device
from torch_port_helpers import ATOL, RTOL


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(settings, "DEVICE", "cpu")
    monkeypatch.setenv("VAEX_TPU_TORCH_DEVICE", "cpu")


def sky_arrays(n=600, seed=11):
    rng = np.random.default_rng(seed)
    return dict(ra=rng.uniform(0, 360, n), dec=np.degrees(np.arcsin(rng.uniform(-1, 1, n))),
                pm_ra=rng.normal(0, 5, n), pm_dec=rng.normal(0, 5, n),
                parallax=rng.uniform(0.5, 20.0, n), x=rng.normal(0, 1, n),
                y=rng.normal(0, 1, n), z=rng.normal(0, 1, n), vx=rng.normal(0, 10, n),
                vy=rng.normal(0, 10, n), vz=rng.normal(0, 10, n))


@pytest.fixture
def frames():
    a = sky_arrays()
    return vaex_tpu.from_arrays(**a), vaex_tpu_torch.from_arrays(**a).to_device("cpu")


def columns_agree(ref, port, names, rtol=RTOL, atol=ATOL):
    for name in names:
        npt.assert_allclose(np.asarray(port.evaluate(name)), np.asarray(ref.evaluate(name)),
                            rtol=rtol, atol=atol, err_msg=name)
        assert expression_is_device(port, name), name


GEO = {
    "spherical2cartesian": (lambda g: g.spherical2cartesian("ra", "dec", "parallax",
                                                            xname="cx", yname="cy", zname="cz",
                                                            center=(1, 2, 3)),
                            ["cx", "cy", "cz"]),
    "cartesian2spherical": (lambda g: g.cartesian2spherical("x", "y", "z", alpha="al",
                                                            delta="de", distance="d",
                                                            center=(0.5, 0, -1)),
                            ["al", "de", "d"]),
    "cartesian2polar": (lambda g: g.cartesian2polar("x", "y"), ["polar_radius", "polar_azimuth"]),
    "cartesian_to_polar_radians": (lambda g: g.cartesian_to_polar("x", "y", radius_out="r2",
                                                                  azimuth_out="a2", radians=True),
                                   ["r2", "a2"]),
    "rotation_2d": (lambda g: g.rotation_2d("x", "y", "xr", "yr", 30), ["xr", "yr"]),
    "velocity_cartesian2polar": (lambda g: g.velocity_cartesian2polar(), ["vr_polar",
                                                                          "vphi_polar"]),
    "velocity_cartesian2spherical": (lambda g: g.velocity_cartesian2spherical(),
                                     ["vr", "vlong", "vlat"]),
    "polar2cartesian": (lambda g: g.polar2cartesian("ra", "parallax", x_out="px", y_out="py"),
                        ["px", "py"]),
    "velocity_polar2cartesian": (lambda g: g.velocity_polar2cartesian(
        velocity_radial="vx", velocity_azimuthal="vy", velocity_cartesian_x="ux",
        velocity_cartesian_y="uy"), ["ux", "uy"]),
    "bearing": (lambda g: g.bearing("ra", "dec", "x", "y"), ["bearing"]),
    "project_aitoff": (lambda g: g.project_aitoff("ra", "dec", radians=False),
                       ["x_aitoff", "y_aitoff"]),
    "project_gnomic": (lambda g: g.project_gnomic("ra", "dec", alpha0=10, delta0=20),
                       ["x_gnomic", "y_gnomic"]),
}


@pytest.mark.parametrize("name", sorted(GEO))
def test_geo(frames, name):
    make, names = GEO[name]
    for df in frames:
        make(df.geo)
    columns_agree(*frames, names)
    port = frames[1]
    npt.assert_allclose(port.mean(names[0]), frames[0].mean(names[0]), rtol=RTOL, atol=ATOL)


def test_geo_propagate_uncertainties(frames):
    for df in frames:
        df["x_uncertainty"] = "0.1 + 0 * x"
        df["y_uncertainty"] = "0.2 + 0 * y"
        df.geo.cartesian2polar("x", "y", propagate_uncertainties=True)
    # neither package differentiates degrees(arctan2(...)): the radius alone
    columns_agree(*frames, ["polar_radius_uncertainty"])
    assert "polar_azimuth_uncertainty" not in frames[1].get_column_names()


def polygons():
    return ([[0, 1, 1, 0], [-1, 0, -0.5], [0.5, 2, 2, 0.5]],
            [[0, 0, 1, 1], [-1, -1, 1], [-2, -2, -0.5, -0.5]])


def test_inside_polygon(frames):
    (px, _, _), (py, _, _) = polygons()
    counts = []
    for df in frames:
        inside = df.geo.inside_polygon("x", "y", px, py)
        counts.append(int(df.count(selection=inside)))
    a = sky_arrays()
    want = ((a["x"] > 0) & (a["x"] < 1) & (a["y"] > 0) & (a["y"] < 1)).sum()
    assert counts == [want, want]
    port = frames[1]
    assert expression_is_device(port, str(port.geo.inside_polygon("x", "y", px, py)))


def test_inside_which_polygon(frames):
    pxs, pys = polygons()
    grids = []
    for df in frames:
        which = df.geo.inside_which_polygon("x", "y", pxs, pys)
        grids.append(np.asarray(df.count(binby=[which], limits=[-1.5, 2.5], shape=4)))
        npt.assert_array_equal(np.asarray(df.evaluate(which))[:50],
                               np.asarray(frames[0].evaluate(
                                   frames[0].geo.inside_which_polygon("x", "y", pxs, pys)))[:50])
    npt.assert_array_equal(grids[0], grids[1])
    assert grids[1].sum() == len(frames[1])


ASTRO = {
    "eq2gal": (lambda a: a.eq2gal(), ["l", "b"]),
    "gal2eq": (lambda a: a.gal2eq("ra", "dec", "ra2", "dec2"), ["ra2", "dec2"]),
    "eq2ecl": (lambda a: a.eq2ecl(), ["lambda_", "beta"]),
    "eq2gal_radians": (lambda a: a.eq2gal("x", "y", "lr", "br", radians=True), ["lr", "br"]),
    "pm_eq2gal": (lambda a: a.pm_eq2gal(), ["pm_l", "pm_b"]),
    "pm_gal2eq": (lambda a: a.pm_gal2eq(pm_long="pm_ra", pm_lat="pm_dec", pm_long_out="pa",
                                         pm_lat_out="pd"), ["pa", "pd"]),
    "proper_motion2vperpendicular": (lambda a: a.proper_motion2vperpendicular(
        distance="parallax", pm_long="pm_ra", pm_lat="pm_dec"), ["vl", "vb"]),
    "cartesian_angular_momenta": (lambda a: a.cartesian_angular_momenta(), ["Lx", "Ly", "Lz"]),
    "parallax2distance": (lambda a: a.parallax2distance(parallax_uncertainty="0.1"),
                          ["distance", "distance_uncertainty"]),
}


@pytest.mark.parametrize("name", sorted(ASTRO))
def test_astro(frames, name):
    make, names = ASTRO[name]
    outs = [make(df.astro) for df in frames]
    columns_agree(*outs, names)
    for df, out in zip(frames, outs):
        assert out is not df and names[0] not in df.get_column_names()


def test_astro_inplace(frames):
    port = frames[1]
    assert port.astro.eq2gal(inplace=True) is port and "l" in port.get_column_names()


def test_eq2gal_matrix_oracle(frames):
    """vaex_tpu's oracle (tests/test_astro.py:42-55): the rotation as a
    matrix product in numpy."""
    from vaex_tpu_torch.astro import FRAME_MATRICES
    df = frames[1].astro.eq2gal("ra", "dec", "l", "b")
    a = sky_arrays()
    ra, dec = np.radians(a["ra"]), np.radians(a["dec"])
    out = np.asarray(FRAME_MATRICES["eq2gal"]) @ np.stack(
        [np.cos(ra) * np.cos(dec), np.sin(ra) * np.cos(dec), np.sin(dec)])
    npt.assert_allclose(df.evaluate("l"), np.degrees(np.arctan2(out[1], out[0])), atol=1e-9)
    npt.assert_allclose(df.evaluate("b"), np.degrees(
        np.pi / 2 - np.arccos(out[2] / np.linalg.norm(out, axis=0))), atol=1e-9)
    back = df.astro.gal2eq("l", "b", "ra2", "dec2")
    npt.assert_allclose(np.mod(back.evaluate("ra2"), 360), a["ra"], atol=2e-4)
    npt.assert_allclose(back.evaluate("dec2"), a["dec"], atol=2e-4)


def test_pm_rotation_is_orthogonal(frames):
    df = frames[1].astro.pm_eq2gal()
    a = sky_arrays()
    npt.assert_allclose(np.hypot(df.evaluate("pm_l"), df.evaluate("pm_b")),
                        np.hypot(a["pm_ra"], a["pm_dec"]), rtol=1e-9)
    back = df.astro.pm_gal2eq("ra", "dec", "pm_l", "pm_b", "pm_ra2", "pm_dec2",
                              name_prefix="__pm_back")
    npt.assert_allclose(back.evaluate("pm_ra2"), a["pm_ra"], rtol=1e-8, atol=1e-10)


def test_angular_momenta_and_vperp_oracles(frames):
    from vaex_tpu_torch.astro import K_PM
    a = sky_arrays()
    df = frames[1].astro.cartesian_angular_momenta()
    L = np.cross(np.stack([a["x"], a["y"], a["z"]], 1), np.stack([a["vx"], a["vy"], a["vz"]], 1))
    for i, name in enumerate(("Lx", "Ly", "Lz")):
        npt.assert_allclose(df.evaluate(name), L[:, i], rtol=1e-9, atol=1e-12)
    df = frames[1].astro.parallax2distance().astro.proper_motion2vperpendicular(
        pm_long="pm_ra", pm_lat="pm_dec")
    npt.assert_allclose(df.evaluate("vl"), K_PM * a["pm_ra"] / a["parallax"], rtol=1e-9)


def test_scalar_variable_on_the_left(frames):
    """A number kept as a variable reads as a Python scalar in a pass, so
    it may stand left of a column (``pi / 2 - x``, ``k_pm * x``)."""
    port = frames[1]
    port.add_variable("c", 2.5)
    port.add_variable("n", np.int64(3))
    npt.assert_allclose(port.evaluate("c / 2 - x * n"), 1.25 - sky_arrays()["x"] * 3)
    npt.assert_allclose(port.sum("c * x"), 2.5 * port.sum("x"), rtol=1e-12)


# ------------------------------------------------------------------- struct


def struct_arrays():
    import pyarrow as pa
    s = pa.StructArray.from_arrays([pa.array([1, 2, 3, 4]), pa.array(["a", "b", None, "d"]),
                                    pa.array([1.5, None, 3.5, 4.5])], names=["i", "s", "f"])
    return dict(st=s, x=np.arange(4.0))


@pytest.fixture
def struct_frames():
    return (vaex_tpu.from_arrays(**struct_arrays()),
            vaex_tpu_torch.from_arrays(**struct_arrays()))


def test_struct_get(struct_frames):
    outs = []
    for df in struct_frames:
        st = df.st.struct
        assert st.keys() == ["i", "s", "f"] and len(st) == 3
        outs.append([df.evaluate(st["i"]), df.evaluate(st.get(2)), df.evaluate(st.get("s")),
                     df.sum(st["i"]), df.sum(st["f"]), df.mean(st["i"] + df.x)])
    for r, p in zip(*outs):
        if hasattr(r, "to_pylist") or getattr(r, "dtype", None) == object:  # the strings
            def values(a):
                return a.to_pylist() if hasattr(a, "to_pylist") else np.ma.asarray(a).tolist(None)
            assert values(r) == values(p) == ["a", "b", None, "d"]
        else:  # a null float field: NaN in vaex_tpu, masked in the port
            npt.assert_allclose(np.ma.filled(np.ma.asarray(p).astype(float), np.nan),
                                np.ma.filled(np.ma.asarray(r).astype(float), np.nan))


def test_struct_project(struct_frames):
    outs = []
    for df in struct_frames:
        st = df.st.struct
        projected = df.evaluate(st.project(["f", "i"]))
        assert [f.name for f in projected.type] == ["f", "i"]
        outs.append(projected.to_pylist())
        assert [k for k, _ in st.items()] == ["i", "s", "f"]
        assert [str(v) for v in st.values()] == ["struct_get(st, 'i')", "struct_get(st, 's')",
                                                 "struct_get(st, 'f')"]
    assert outs[0] == outs[1] == [{"f": 1.5, "i": 1}, {"f": None, "i": 2}, {"f": 3.5, "i": 3},
                                  {"f": 4.5, "i": 4}]


def test_struct_is_host_stage(struct_frames):
    port = struct_frames[1]
    assert not expression_is_device(port, "struct_get(st, 'i')")
    assert expression_is_device(port, "x * 2")


# ---------------------------------------------------------------------- viz


@pytest.fixture
def viz_frames():
    x = np.arange(10, dtype="f8")
    arrays = dict(x=x, y=x ** 2, g=np.arange(10) % 3)
    return vaex_tpu.from_arrays(**arrays), vaex_tpu_torch.from_arrays(**arrays).to_device("cpu")


@pytest.mark.parametrize("what,binby,limits,shape,selection", [
    ("count(*)", ["x"], [[0, 10]], 5, None),
    ("count(y)", ["x"], [[0, 10]], 5, "y > 10"),
    ("mean(y)", ["x"], [[0, 10]], 2, None),
    ("sum(y)", ["x", "y"], [[0, 10], [0, 100]], 4, None),
    ("max(x)", ["g"], [[0, 3]], 3, "x > 2"),
    ("std", ["x"], [[0, 10]], 2, None),
])
def test_what_grid(viz_frames, what, binby, limits, shape, selection):
    ref, port = (df.viz._what_grid(what if what != "std" else "std(y)", binby, limits, shape,
                                   selection) for df in viz_frames)
    npt.assert_allclose(np.asarray(port, float), np.asarray(ref, float), rtol=RTOL, atol=ATOL,
                        equal_nan=True)


def test_grids_need_no_matplotlib(viz_frames, monkeypatch):
    """The grid is computed before matplotlib is imported: without it the
    grid is there and only the drawing fails."""
    for name in ("matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    port = viz_frames[1]
    npt.assert_array_equal(port.viz._what_grid("count(*)", ["x"], [[0, 10]], 5, None),
                           [2, 2, 2, 2, 2])
    with pytest.raises(ImportError):
        port.viz.histogram("x", shape=5, limits=[0, 10])


def test_drawings(viz_frames):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    grids = []
    for df in viz_frames:
        h = df.viz.histogram("x", shape=5, limits=[0, 10], figsize=(3, 2))
        m = df.viz.histogram("x", what="mean(y)", shape=2, limits=[0, 10])
        hm = df.viz.heatmap("x", "y", shape=4, limits=[[0, 10], [0, 100]], logscale=True)
        df.viz.scatter("x", "y", c="k", selection="x > 3")
        with pytest.raises(ValueError):
            df.viz.scatter("x", "y", length_limit=5)
        grids.append((h, m, hm))
        plt.close("all")
    npt.assert_array_equal(grids[1][0], [2, 2, 2, 2, 2])
    npt.assert_allclose(grids[1][1], [np.mean(np.arange(5.0) ** 2), np.mean(np.arange(5, 10.0) ** 2)])
    assert np.asarray(grids[1][2]).sum() == 10
    for r, p in zip(*grids):
        npt.assert_allclose(np.asarray(p, float), np.asarray(r, float))


# ---------------------------------------------------------------------- CLI


def test_cli_convert_meta_stat_open(tmp_path, capsys):
    from vaex_tpu.__main__ import main as ref_main
    from vaex_tpu_torch.__main__ import main
    rng = np.random.default_rng(3)
    arrays = dict(a=np.arange(50, dtype="f8"), k=rng.integers(0, 5, 50), f=rng.random(50).astype("f4"))
    src = str(tmp_path / "in.arrow")
    vaex_tpu_torch.from_arrays(**arrays).export(src)
    for out in ("out.parquet", "out.hdf5", "out.csv"):
        main(["convert", src, str(tmp_path / out)])
        assert capsys.readouterr().out.strip() == f"wrote {tmp_path / out}"
        back = vaex_tpu_torch.open(str(tmp_path / out))
        npt.assert_array_equal(back.evaluate("a"), arrays["a"])
        npt.assert_array_equal(back.evaluate("k"), arrays["k"])
    meta = {}
    for name, fn in (("ref", ref_main), ("port", main)):
        fn(["meta", src])
        meta[name] = json.loads(capsys.readouterr().out)
    # vaex_tpu names an Arrow IPC file's types as arrow does ("double")
    assert meta["port"] == {"rows": 50, "columns": {"a": "float64", "k": "int64", "f": "float32"}}
    assert meta["ref"]["rows"] == 50 and list(meta["ref"]["columns"]) == ["a", "k", "f"]
    main(["stat", src])
    stat = capsys.readouterr().out
    assert "mean" in stat and "24.5" in stat
    main(["open", src, str(tmp_path / "out.parquet")])
    assert capsys.readouterr().out.count(": OK (50 rows)") == 2
    with pytest.raises(SystemExit) as e:
        main(["open", str(tmp_path / "missing.hdf5")])
    assert e.value.code == 1


def test_cli_benchmark_names_its_script(capsys):
    from vaex_tpu_torch.__main__ import main
    with pytest.raises(SystemExit) as e:
        main(["benchmark"])
    assert e.value.code != 0 and "ROADMAP A1" in capsys.readouterr().err


def test_cli_webserver(tmp_path, monkeypatch, capsys):
    """webserver opens each file under its name and hands the frames to the
    flavor's serve."""
    from vaex_tpu_torch.__main__ import main
    from vaex_tpu_torch.server import asgi
    src = str(tmp_path / "sky.arrow")
    vaex_tpu_torch.from_arrays(x=np.arange(20.0)).export(src)
    served = {}
    monkeypatch.setattr(asgi, "serve", lambda frames, **kw: served.update(frames=frames, **kw))
    main(["webserver", src, "--flavor", "asgi", "--port", "9123", "--token", "t"])
    assert list(served["frames"]) == ["sky"] and served["port"] == 9123
    assert served["token"] == "t" and served["frames"]["sky"].sum("x") == 190
    assert "serving ['sky'] on port 9123" in capsys.readouterr().out


def test_cli_help(capsys):
    from vaex_tpu_torch.__main__ import main
    main([])
    assert "convert" in capsys.readouterr().out
