"""Tooling tests: vkr2obj, vktinfo, vktconvert, blender exporter core."""

import numpy as np
import pytest

from realtimepathtracingresearchframework_tpu.models import procedural, texture, vkr
from realtimepathtracingresearchframework_tpu.tools import (
    blender_vkr,
    vkr2obj,
    vktconvert,
    vktinfo,
)
from realtimepathtracingresearchframework_tpu.utils.image_io import write_png


def test_vkr2obj(tmp_path):
    p = str(tmp_path / "c.vks")
    vkr.write_scene(p, procedural.cornell_box())
    out = str(tmp_path / "c.obj")
    assert vkr2obj.main([p, out]) == 0
    text = open(out).read()
    assert text.count("\nf ") == 32
    assert text.count("\nv ") == 96


def test_vktinfo(tmp_path, capsys, rng):
    p = str(tmp_path / "t.vkt")
    texture.write_vkt(p, (rng.random((8, 16, 4)) * 255).astype(np.uint8))
    assert vktinfo.main([p]) == 0
    out = capsys.readouterr().out
    assert "16 x 8" in out and "R8G8B8A8_UNORM" in out


def test_vktconvert_pow2_upsample(tmp_path, rng):
    png = str(tmp_path / "in.png")
    write_png(png, (rng.random((10, 12, 3)) * 255).astype(np.uint8))
    out = str(tmp_path / "out.vkt")
    assert vktconvert.main([png, out]) == 0
    t = texture.read_vkt(out)
    assert (t.width, t.height) == (16, 16)


def test_blender_export_core(tmp_path):
    tris = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    ident = np.zeros((3, 4), np.float32)
    ident[:, :3] = np.eye(3)
    out = str(tmp_path / "b.vks")
    blender_vkr.export_scene_data(
        meshes=[{"name": "m", "triangles": tris, "material_ids": np.zeros(1)}],
        instances=[{"name": "i", "mesh_id": 0, "transform": ident}],
        materials=[{"name": "Mat", "base_color": (0.5, 0.2, 0.1), "emission": 0.0}],
        out_path=out,
    )
    back = vkr.open_scene(out)
    assert back.num_triangles == 1
    assert back.materials[0].name == "Mat"
    np.testing.assert_allclose(back.materials[0].base_color, [0.5, 0.2, 0.1], atol=1e-6)


@pytest.mark.slow
def test_precompile_tool(tmp_path):
    """AOT lattice precompiler (gpu_programs.cmake:228-374 analogue):
    one tiny cell compiles into a fresh persistent cache and the JSON
    summary reports the entry delta. Runs in a subprocess so the
    in-process jit cache of earlier tests can't mask the compile."""
    import json
    import os
    import subprocess
    import sys

    cache = str(tmp_path / "cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=cache)
    out = subprocess.run(
        [sys.executable, "-m",
         "realtimepathtracingresearchframework_tpu.tools.precompile",
         "--scenes", "cornell", "--img", "16", "16",
         "--variants", "PT_MEGAKERNEL", "--max-depth", "2"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-500:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["cells"] == 1 and summary["failed"] == 0
    assert summary["cache_entries_after"] > 0


def test_prepare_sobol_roundtrip(tmp_path):
    """Joe-Kuo generator: extract compact source from the shipped
    matrices, regenerate, and rebuild the inversion tile — all three
    must be bit-exact (prepare_sobol.cpp parity)."""
    from realtimepathtracingresearchframework_tpu.ops.pointsets_tables import (
        _tables_np,
    )
    from realtimepathtracingresearchframework_tpu.tools import prepare_sobol

    t = _tables_np()
    mats = np.asarray(t["sobol_matrix"], np.uint32)
    # first dims cover degrees 1..8 — full-table extraction is exercised
    # by the CLI; keep the CI slice fast
    sub = mats[:40]
    src = prepare_sobol.extract_source(sub)
    assert src[0] == prepare_sobol.VDC  # van der Corput
    regen = prepare_sobol.generate_matrices(src)
    np.testing.assert_array_equal(regen, sub)

    # source file round-trip (the Joe-Kuo text format)
    p = tmp_path / "joe_kuo.txt"
    prepare_sobol.write_joe_kuo_file(src, str(p))
    back = prepare_sobol.read_joe_kuo_file(str(p))
    assert back == src

    # inversion tile vs the shipped SobolInversion_1_0 conversion
    tile = prepare_sobol.inversion_tile(mats, 256, 0, 1)
    np.testing.assert_array_equal(
        tile, np.asarray(t["sobol_invert"], np.uint32)
    )
