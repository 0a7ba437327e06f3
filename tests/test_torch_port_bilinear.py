"""The port's bilinear sampler (catgen_torch/kernels/bilinear.py) on the
CPU: its plain version against catgen's, and the wrapper's contract.

The CUDA kernel itself runs only on a card (chip_smoke.py holds it
against the plain version there); here the wrapper must take the plain
version for CPU tensors and refuse anything else it cannot launch.

Shapes are the two the sampling path gives the sampler, at N=2: the input
ST (32x32x3 -> 32x32, catgen's separable v4 body) and the three branch STs
stacked (16x16x64 -> 48x16, the dense v4 body). Coordinates span
[-1.2, 1.2] so the edge clamps are hit.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.kernels.pallas_bilinear_v4 import \
    bilinear_sample_rows as v4_sample_rows
from catgen.nn.spatial_transformer import bilinear_sample as jax_sample
from catgen_torch.kernels import bilinear, build
from catgen_torch.nn.spatial_transformer import bilinear_sample

SHAPES = [(2, 32, 32, 3, 32, 32), (2, 16, 16, 64, 48, 16)]


def _inputs(shape, seed=0):
    n, h, w, c, ho, wo = shape
    rng = np.random.RandomState(seed)
    img = rng.rand(n, h, w, c).astype(np.float32)
    rows = rng.uniform(-1.2, 1.2, (n, 2, ho * wo)).astype(np.float32)
    return img, rows


def _grid(rows, ho, wo):
    """(N, 2, P) rows -> catgen's (N, Ho, Wo, 2) coords."""
    return rows.transpose(0, 2, 1).reshape(rows.shape[0], ho, wo, 2)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_catgen_bilinear_sample(shape):
    # same f32 formula on both sides: equal to rounding, atol 1e-5
    n, h, w, c, ho, wo = shape
    img, rows = _inputs(shape)
    want = np.asarray(jax_sample(jnp.asarray(img),
                                 jnp.asarray(_grid(rows, ho, wo))))
    got = bilinear.bilinear_sample_rows(torch.tensor(img), torch.tensor(rows),
                                        (ho, wo))
    assert got.shape == (n, ho, wo, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_catgen_v4_interpret(shape):
    # the TPU kernel rounds its operands to bf16: v4's own tolerance
    # (tests/test_pallas_kernels.py), rtol 2e-2, atol 1e-2
    n, h, w, c, ho, wo = shape
    img, rows = _inputs(shape, seed=1)
    want = np.asarray(v4_sample_rows(jnp.asarray(img), jnp.asarray(rows),
                                     (ho, wo), True))
    got = bilinear.bilinear_sample_rows_plain(torch.tensor(img),
                                              torch.tensor(rows), (ho, wo))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=1e-2)


def test_grid_form_matches_rows_form():
    img, rows = _inputs(SHAPES[1])
    a = bilinear_sample(torch.tensor(img),
                        torch.tensor(_grid(rows, 48, 16)))
    b = bilinear.bilinear_sample_rows_plain(torch.tensor(img),
                                            torch.tensor(rows), (48, 16))
    assert torch.equal(a, b)


def test_cpu_tensors_take_plain_version_and_count_no_launch():
    img, rows = _inputs(SHAPES[0])
    before = bilinear.LAUNCHES
    out = bilinear.bilinear_sample_rows(torch.tensor(img), torch.tensor(rows),
                                        (32, 32))
    assert bilinear.LAUNCHES == before
    assert torch.equal(out, bilinear.bilinear_sample_rows_plain(
        torch.tensor(img), torch.tensor(rows), (32, 32)))


def test_non_cpu_tensors_never_fall_back():
    # a tensor that is not on the CPU goes to the kernel or raises; a
    # "meta" tensor stands in for a device the kernel cannot take
    img = torch.empty((2, 16, 16, 64), device="meta")
    rows = torch.empty((2, 2, 768), device="meta")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bilinear.bilinear_sample_rows(img, rows, (48, 16))


@pytest.mark.parametrize("bad", ["dtype", "shape", "rank", "contiguous"])
def test_launch_checks_inputs(bad):
    # "meta" tensors carry shape, dtype and strides but no data: every
    # check runs before the device check and before any CUDA call
    img = torch.empty((2, 16, 16, 64), device="meta")
    rows = torch.empty((2, 2, 768), device="meta")
    out_hw = (48, 16)
    if bad == "dtype":
        img = img.double()
    elif bad == "shape":
        out_hw = (32, 16)
    elif bad == "rank":
        img = img[0]
    else:
        img = img.transpose(1, 2)
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err) as info:
        bilinear.launch(img, rows, out_hw)
    assert "needs CUDA tensors" not in str(info.value)


def test_backward_names_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="Queue B item 2"):
        bilinear._BilinearSampleRows.backward(None, torch.zeros(1))


def test_build_without_nvcc_raises(monkeypatch):
    from torch.utils import cpp_extension
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_build_failure_reports_nvcc_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compile failure' >&2\n"
                    "exit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compile failure"):
        build.build_library()
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build.library_path()
    src.write_text("// two\n")
    assert build.library_path() != first
    assert build.library_path().parent == build.BUILD_DIR
    assert os.path.basename(first).startswith("libcatgen_torch_")
