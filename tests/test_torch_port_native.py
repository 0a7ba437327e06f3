"""The port's native JPEG decoder (catgen_torch/native/fastimage.cpp,
catgen_torch/data/native_decode.py) and the rest of its loader (the
native cache fill, the refusal of undecodable files, per-process corpus
sharding, the rank's rows of an epoch) against catgen's
(catgen/data/native_decode.py, catgen/data/loader.py). Both decoders
build here (g++ and jpeglib.h are present), and decoded images are
compared bit for bit; catgen's own test holds them within a mean
absolute 4.0 of PIL's resize, which the fixture's native size matches
exactly."""

import os

import jax
import numpy as np
import pytest
from PIL import Image

from catgen.data import loader as cloader
from catgen.data import native_decode as cnative
from catgen_torch.data import loader as tloader
from catgen_torch.data import native_decode as tnative
from catgen_torch.data.fixture import write_fixture_dataset
from catgen_torch.dist import mesh


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_jpegs")
    write_fixture_dataset(str(d), n=16, size=96, seed=2)
    return sorted(os.path.join(str(d), f) for f in os.listdir(str(d)))


@pytest.mark.parametrize("size", [96, 64, 32])
def test_decoder_matches_catgen_bit_for_bit(jpegs, size):
    """At the file's size (no resize) and at two bilinear resizes."""
    got, ok = tnative.decode_batch_checked(jpegs, size)
    want, want_ok = cnative.decode_batch_checked(jpegs, size)
    assert got.shape == (16, size, size, 3) and got.dtype == np.uint8
    assert ok.all() and want_ok.all()
    np.testing.assert_array_equal(got, want)


def test_decoder_within_catgen_bound_of_pil(jpegs):
    """catgen's tests/test_native.py bound: mean |native - PIL| < 4.0."""
    out, _ = tnative.decode_batch_checked(jpegs[:1], 64)
    ref = np.asarray(Image.open(jpegs[0]).convert("RGB")
                     .resize((64, 64), Image.BILINEAR))
    assert np.abs(out[0].astype(int) - ref.astype(int)).mean() < 4.0


def test_failures_are_masked_and_zero_filled(jpegs, tmp_path):
    bad = str(tmp_path / "not_a.jpg")
    with open(bad, "wb") as f:
        f.write(b"definitely not a jpeg")
    paths = [jpegs[0], bad, str(tmp_path / "missing.jpg")]
    out, ok = tnative.decode_batch_checked(paths, 32)
    assert list(ok) == [True, False, False]
    assert (out[1] == 0).all() and (out[2] == 0).all()
    want, want_ok = cnative.decode_batch_checked(paths, 32)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(out, want)


def test_library_is_keyed_by_source_and_flags():
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR
    assert path.name.startswith("libfastimage_") and path.exists()


def test_loader_fills_natively_as_catgen_does(jpegs):
    """The cache and a random sample equal catgen's loader's bits."""
    d = os.path.dirname(jpegs[0])
    ds = tloader.ImageDataset([d], scale=32, seed=4)
    want = cloader.ImageDataset([d], scale=32, seed=4)
    np.testing.assert_array_equal(ds.sample_uint8(8), want.sample_uint8(8))
    assert ds.decoder_used == "native" and ds.decoder_error is None
    np.testing.assert_allclose(ds.load_images(0, 4).numpy(),
                               np.asarray(want.load_images(0, 4)),
                               atol=1e-6)


def test_loader_says_when_pil_ran(jpegs, monkeypatch):
    d = os.path.dirname(jpegs[0])
    pil = tloader.ImageDataset([d], scale=32, decoder="pil")
    pil.slice_uint8(0, 1)
    assert pil.decoder_used == "pil" and "pil" in pil.decoder_error

    def no_compiler(*args, **kwargs):
        raise ImportError("no C++ compiler")

    monkeypatch.setattr(tnative, "decode_batch_checked", no_compiler)
    fallback = tloader.ImageDataset([d], scale=32)
    fallback.slice_uint8(0, 1)
    assert fallback.decoder_used == "pil"
    assert "no C++ compiler" in fallback.decoder_error
    with pytest.raises(ImportError):
        tloader.ImageDataset([d], scale=32, decoder="native").slice_uint8(
            0, 1)


def test_loader_refuses_undecodable_files(tmp_path):
    """catgen's refusal: a zero-filled slot would train as a black real."""
    write_fixture_dataset(str(tmp_path), n=4, size=64, seed=1)
    with open(tmp_path / "zz_corrupt.jpg", "wb") as f:
        f.write(b"\xff\xd8\xff garbage")
    for mod in (tloader, cloader):
        ds = mod.ImageDataset([str(tmp_path)], scale=32)
        with pytest.raises(ValueError, match="failed to decode"):
            ds.load_random_images(2)


def test_shard_by_process_matches_catgen(tmp_path, monkeypatch):
    """catgen's tests/test_multihost.py::test_loader_shards_paths_by_process:
    process 1 of 2 decodes paths[1::2] and draws from seed + 7919."""
    for i in range(10):
        Image.new("RGB", (8, 8), (i, i, i)).save(tmp_path / f"{i:03d}.jpg")
    all_paths = tloader.scan_paths([str(tmp_path)])
    monkeypatch.setattr(mesh, "_process", (1, 2))
    monkeypatch.setattr(jax, "process_index", lambda: 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    ds = tloader.ImageDataset([str(tmp_path)], scale=8, source_size=8,
                              shard_by_process=True, seed=3)
    want = cloader.ImageDataset([str(tmp_path)], scale=8, source_size=8,
                                shard_by_process=True, seed=3)
    assert ds.paths == all_paths[1::2] == want.paths and len(ds) == 5
    np.testing.assert_array_equal(ds.sample_uint8(6), want.sample_uint8(6))


@pytest.mark.parametrize("d_iterations", [1, 2])
def test_epoch_batches_keep_the_rank_rows(jpegs, d_iterations):
    """A rank's epoch is its contiguous share of each step's global rows,
    as catgen's mesh shards them (P(None, 'data'))."""
    d = os.path.dirname(jpegs[0])
    whole = tloader.ImageDataset([d], scale=16, seed=9).epoch_batches(
        24, 6, d_iterations)
    per = d_iterations * 6 // 3
    for rank in range(3):
        part = tloader.ImageDataset([d], scale=16, seed=9).epoch_batches(
            24, 6, d_iterations, shard=(rank, 3))
        np.testing.assert_array_equal(
            part.numpy(), whole[:, rank * per:(rank + 1) * per].numpy())
