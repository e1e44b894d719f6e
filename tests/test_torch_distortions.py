"""PyTorch port vs the JAX package: the distortion bench.

Every batched attack of ``gswm_torch.distortions.device`` against
``gswm.distortions.device`` on the CPU, on images from a numpy seed, with the
JAX package's own draws fed to the randomized attacks (a jax key and a
``torch.Generator`` give different numbers, so randomness never crosses the
packages).  Tolerance: float32, max |diff| <= 1e-5 (measured <= 6e-6: elastic,
whose displacement of up to 90 pixels multiplies the rounding of its smoothed
field; everything else <= 1e-6, the flips, ``invert``, ``erasing``,
``randomcrop``, ``noise`` and ``rotation`` exact).  The DCT JPEG under a
tolerance of its own, see ``test_jpeg_matches_jax``.  The host (PIL) attacks
equal the reference's byte for byte.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from gswm.distortions import attacks as j_attacks
from gswm.distortions import device as jdev
from gswm.distortions import utils as j_utils
from gswm_torch.cli import gs_distort
from gswm_torch.distortions import (
    DISTORTION_STRENGTH_PARAS,
    apply_distortion,
    apply_multiple_distortions,
    apply_single_distortion,
    device_attacks,
    relative_strength_to_absolute,
)
from gswm_torch.distortions import device as dev
from gswm_torch.distortions.utils import set_random_seed, to_pil, to_tensor
from gswm_torch.pipelines import InversablePipeline

torch.set_num_threads(2)

ATOL = 1e-5
DEVICE_ATTACKS = [n for n in DISTORTION_STRENGTH_PARAS if n != "reversed"]
# non-square, and one whose sides are no multiple of 8 (the JPEG's edge padding)
SHAPES = [(2, 3, 64, 48), (1, 3, 40, 40)]


def images(shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def jax_draws(name: str, key, shape):
    """The draws ``gswm.distortions.device`` takes from ``key`` for one
    attack, by the same jax calls (device.py:24, 109-111, 128-130, 140-142,
    176-178)."""
    h, w = shape[-2:]
    if name == "noise":
        return np.array(jax.random.normal(key, shape))
    if name in ("resizedcrop", "erasing", "randomcrop"):
        ki, kj = jax.random.split(key)
        return (np.array(jax.random.uniform(ki, ())),
                np.array(jax.random.uniform(kj, ())))
    if name == "elastic":
        kd, kx = jax.random.split(key)
        return (np.array(jax.random.uniform(kd, (h, w))),
                np.array(jax.random.uniform(kx, (h, w))))
    return None


def test_tables_equal_the_reference():
    assert DISTORTION_STRENGTH_PARAS == j_attacks.DISTORTION_STRENGTH_PARAS
    assert list(DISTORTION_STRENGTH_PARAS) == list(j_attacks.DISTORTION_STRENGTH_PARAS)
    np.testing.assert_array_equal(dev._Q_LUMA, jdev._Q_LUMA)
    np.testing.assert_array_equal(dev._Q_CHROMA, jdev._Q_CHROMA)
    np.testing.assert_array_equal(dev._dct_mat().numpy(), np.asarray(jdev._dct_mat()))
    for q in (1, 10, 49, 50, 75, 100, 130):
        assert dev._quality_scale(q) == jdev._quality_scale(q)
        for got, want in zip(dev._quant_tables(q), jdev._quant_tables(q)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert device_attacks is dev
    assert set(dev.RANDOMIZED) <= set(DEVICE_ATTACKS)
    for name in DISTORTION_STRENGTH_PARAS:
        for rel in (0.0, 0.1, 0.25, 0.5, 0.9, 1.0):
            assert relative_strength_to_absolute(rel, name) == \
                j_attacks.relative_strength_to_absolute(rel, name)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("rel", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("name", DEVICE_ATTACKS)
def test_device_attack_matches_jax(name, rel, shape):
    x = images(shape)
    s = relative_strength_to_absolute(rel, name)
    key = jax.random.key(7)
    want = np.asarray(jdev.apply(jnp.asarray(x), name, s, key=key))
    got = dev.apply(torch.from_numpy(x), name, s, draws=jax_draws(name, key, shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if name == "compression":
        assert_jpeg_close(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def assert_jpeg_close(got: np.ndarray, want: np.ndarray) -> None:
    """The two packages sum the 8 x 8 DCT products in different orders, so a
    coefficient within an ulp of k + 1/2 may quantise one step apart, which
    moves its block by up to a quantisation step / 255.  Stated from what was
    measured (no such coefficient at these sizes: max |diff| 2.4e-7): all but
    0.1% of the pixels within 1e-5, mean |diff| <= 1e-4."""
    diff = np.abs(got - want)
    assert (diff > ATOL).mean() <= 1e-3, (diff > ATOL).mean()
    assert diff.mean() <= 1e-4, diff.mean()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("quality", [10, 50, 90])
def test_jpeg_matches_jax(quality, shape):
    x = images(shape, seed=3)
    want = np.asarray(jdev.jpeg_compress(jnp.asarray(x), quality))
    got = dev.jpeg_compress(torch.from_numpy(x), quality).numpy()
    assert got.shape == want.shape == shape
    assert_jpeg_close(got, want)
    assert np.abs(got - x).mean() > 1e-3  # and it did compress


def test_blockwise_pads_edges_and_crops_back():
    x = torch.from_numpy(images((2, 3, 13, 21), seed=4))
    seen = []

    def fn(blocks):
        seen.append(tuple(blocks.shape))
        return blocks

    out = dev._blockwise(x, fn)
    assert seen == [(2, 3, 2, 3, 8, 8)]
    assert torch.equal(out, x)
    want = np.asarray(jdev._blockwise(jnp.asarray(x.numpy()), lambda b: b * 2.0))
    np.testing.assert_array_equal(dev._blockwise(x, lambda b: b * 2.0).numpy(), want)


def test_bilinear_gather_and_rect_mask_match_jax():
    x = images((2, 3, 20, 17), seed=5)
    rng = np.random.default_rng(6)
    sy = rng.uniform(-3, 23, (20, 17)).astype(np.float32)  # beyond both edges
    sx = rng.uniform(-3, 20, (20, 17)).astype(np.float32)
    want = np.asarray(jdev._bilinear_gather(jnp.asarray(x), jnp.asarray(sy),
                                            jnp.asarray(sx)))
    got = dev._bilinear_gather(torch.from_numpy(x), torch.from_numpy(sy),
                               torch.from_numpy(sx))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want = np.asarray(jdev._rect_mask((20, 17), 3.0, 5.0, 6.0, 4.0))
    got = dev._rect_mask((20, 17), 3.0, 5.0, 6.0, 4.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == 24


# -- cubic resize -------------------------------------------------------------

RESIZES = [((768, 760), (76, 79)), ((768, 760), (230, 233)), ((768, 760), (691, 694)),
           ((76, 68), (768, 771)), ((64, 48), (19, 48)), ((40, 40), (57, 23))]


@pytest.mark.parametrize("src,dst", RESIZES, ids=lambda p: "x".join(map(str, p)))
def test_resize_cubic_matches_jax(src, dst):
    """Shrinks (antialiased) and growths, one axis left alone in one case:
    max |diff| <= 1e-5 (measured <= 1.2e-6)."""
    x = images((1, 3) + src, seed=2)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3) + dst, "cubic"))
    got = dev.resize_cubic(torch.from_numpy(x), dst)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("src,dst", [((64, 48), (19, 14)), ((40, 40), (57, 61))],
                         ids=["shrink", "grow"])
def test_torch_bicubic_interpolate_is_another_function(src, dst):
    """``F.interpolate(mode="bicubic")`` is Keys' kernel with a = -0.75 and,
    as called by default, not antialiased: it differs from the reference's
    resize by far more than the tolerance, so it is never swapped in."""
    x = images((1, 3) + src, seed=2)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3) + dst, "cubic"))
    other = F.interpolate(torch.from_numpy(x), size=dst, mode="bicubic",
                          align_corners=False).numpy()
    assert np.abs(other - want).max() > 1000 * ATOL
    got = dev.resize_cubic(torch.from_numpy(x), dst).numpy()
    assert np.abs(got - want).max() <= ATOL


def test_no_library_resize_in_the_bench():
    port = Path(dev.__file__).resolve().parents[1]
    for sub in ("distortions", "eval"):
        for path in (port / sub).glob("*.py"):
            assert "F.interpolate" not in path.read_text(), path.name


# -- draws and generators -------------------------------------------------------


@pytest.mark.parametrize("name", dev.RANDOMIZED)
def test_randomized_attack_draws_from_its_generator(name):
    """Without draws an attack takes them from the generator it is given: the
    same seed gives the same image, another seed another; with neither it
    seeds one with 0 (the reference's default key)."""
    x = torch.from_numpy(images((2, 3, 32, 32)))
    s = relative_strength_to_absolute(0.5, name)

    def run(seed):
        return dev.apply(x, name, s, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    assert torch.equal(dev.apply(x, name, s), run(0))
    assert not torch.equal(run(3), x)


def test_unknown_attack_raises():
    with pytest.raises(ValueError):
        dev.apply(torch.zeros((1, 3, 8, 8)), "reversed", 1.0)


# -- the port's cases of tests/test_distortions.py ------------------------------


@pytest.fixture()
def img():
    rng = np.random.default_rng(0)
    arr = (rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
    return Image.fromarray(arr)


@pytest.fixture()
def batch():
    return torch.from_numpy(images((2, 3, 64, 64)))


def test_strength_mapping_matches_reference_table():
    assert relative_strength_to_absolute(0.5, "rotation") == 180
    assert relative_strength_to_absolute(0.3, "compression") == 70
    assert relative_strength_to_absolute(1.0, "noise") == 0.5
    assert relative_strength_to_absolute(0.5, "resizedcrop") == pytest.approx(0.55)
    assert relative_strength_to_absolute(0.0, "brightness") == 1


def test_all_16_attacks_run_host(img):
    for name in DISTORTION_STRENGTH_PARAS:
        if name == "reversed":
            continue  # needs a pipeline: test_reversed_regenerates
        out = apply_single_distortion(img, name, None, distortion_seed=3)
        assert isinstance(out, Image.Image)


def test_all_attacks_run_device(batch):
    for name in DEVICE_ATTACKS:
        s = relative_strength_to_absolute(0.5, name)
        out = dev.apply(batch, name, s, generator=torch.Generator().manual_seed(0))
        assert out.shape[0] == 2 and out.shape[1] == 3
        assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize("name", ["horizontal_flip", "vertical_flip", "invert",
                                  "togray", "brightness", "contrast"])
def test_host_device_agree_deterministic(img, name):
    s = relative_strength_to_absolute(0.4, name)
    host = apply_single_distortion(img, name, s)
    x = torch.from_numpy(to_tensor([img], norm_type=None))
    devo = dev.apply(x, name, s)
    host_arr = to_tensor([host.convert("RGB")], norm_type=None)[0]
    np.testing.assert_allclose(devo.numpy()[0], host_arr, atol=0.02)


def test_device_jpeg_close_to_pil():
    """DCT round trip vs libjpeg at QF=50 on a smooth natural-like image:
    same ballpark (not bit-exact — 4:4:4 vs 4:2:0, no entropy coding)."""
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    arr = np.stack([
        128 + 80 * np.sin(yy / 9.0),
        128 + 80 * np.cos(xx / 7.0),
        128 + 60 * np.sin((xx + yy) / 11.0),
    ], axis=-1).clip(0, 255).astype(np.uint8)
    img = Image.fromarray(arr)
    x = torch.from_numpy(to_tensor([img], norm_type=None))
    ours = dev.jpeg_compress(x, 50).numpy()
    pil = apply_single_distortion(img, "compression", 50)
    pil_arr = to_tensor([pil.convert("RGB")], norm_type=None)[0]
    orig = to_tensor([img], norm_type=None)[0]
    assert float(np.mean(np.abs(ours[0] - pil_arr))) < 0.1
    assert float(np.mean(np.abs(ours[0] - orig))) < 0.15


def test_jpeg_quality_ordering(batch):
    """Lower QF must distort more."""
    e90 = float((dev.jpeg_compress(batch, 90) - batch).abs().mean())
    e10 = float((dev.jpeg_compress(batch, 10) - batch).abs().mean())
    assert e10 > e90 > 0


def test_identity_strengths_are_noops(batch):
    """Strength at the identity end should (nearly) not change the image."""
    np.testing.assert_allclose(dev.apply(batch, "rotation", 0.0).numpy(),
                               batch.numpy(), atol=1e-5)
    np.testing.assert_allclose(dev.apply(batch, "brightness", 1.0).numpy(),
                               batch.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        dev.apply(batch, "noise", 0.0,
                  generator=torch.Generator().manual_seed(1)).numpy(),
        batch.numpy(), atol=1e-6)
    assert dev.blurring(batch, 0.4) is batch


def test_per_image_seed_increment(img):
    """same_operation=False gives different noise per image
    (`distortions`:71-79)."""
    outs = apply_distortion([img, img], "noise", 0.8, distortion_seed=0,
                            relative_strength=True)
    a, b = (np.asarray(o) for o in outs)
    assert not np.array_equal(a, b)
    outs_same = apply_distortion([img, img], "noise", 0.8, distortion_seed=0,
                                 same_operation=True, relative_strength=True)
    a, b = (np.asarray(o) for o in outs_same)
    np.testing.assert_array_equal(a, b)


def test_roundtrip_utils(img):
    t = to_tensor([img], norm_type=None)
    back = to_pil(t, norm_type=None)[0]
    np.testing.assert_array_equal(np.asarray(back), np.asarray(img))
    np.testing.assert_array_equal(to_tensor([img]), j_utils.to_tensor([img]))
    np.testing.assert_array_equal(np.asarray(to_pil(to_tensor([img]))[0]),
                                  np.asarray(img))
    set_random_seed(5)
    a = np.random.rand()
    j_utils.set_random_seed(5)
    assert a == np.random.rand()


# -- the host attacks, byte for byte ---------------------------------------------


@pytest.mark.parametrize("strength", [None, 0.3])
@pytest.mark.parametrize("name", DEVICE_ATTACKS)
def test_host_attack_equals_reference_bytes(img, name, strength):
    """The same PIL image, strength and seed through both packages' host
    attack: equal size, mode and bytes.  ``None`` draws the strength from
    the seed."""
    if strength is not None:
        strength = relative_strength_to_absolute(strength, name)
    got = apply_single_distortion(img, name, strength, distortion_seed=11)
    want = j_attacks.apply_single_distortion(img, name, strength, distortion_seed=11)
    assert got.size == want.size
    assert got.convert("RGB").tobytes() == want.convert("RGB").tobytes()


def test_host_batch_and_chain_equal_reference(img):
    other = Image.fromarray(np.asarray(img)[::-1].copy())
    got = apply_distortion([img, other], "elastic", 0.5, distortion_seed=2,
                           return_image=False)
    want = j_attacks.apply_distortion([img, other], "elastic", 0.5, distortion_seed=2,
                                      return_image=False)
    np.testing.assert_array_equal(got, want)
    params = {name: dict(relative_strength=0.3, enable=int(name in
                                                           ("rotation", "noise", "compression")))
              for name in DEVICE_ATTACKS}
    got, applied = apply_multiple_distortions(img, params, distortion_seed=4)
    want, japplied = j_attacks.apply_multiple_distortions(img, params, distortion_seed=4)
    assert applied == japplied and list(applied) == ["rotation", "noise", "compression"]
    assert got.convert("RGB").tobytes() == want.convert("RGB").tobytes()


# -- the port's cases of tests/test_regen_attack.py --------------------------------


def test_reversed_requires_pipe():
    img = Image.fromarray(np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="pipe"):
        apply_single_distortion(img, "reversed", 8)


def test_reversed_regenerates():
    pipe = InversablePipeline("tiny", device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    img = Image.fromarray((rng.uniform(size=(16, 16, 3)) * 255).astype(np.uint8))
    out = apply_single_distortion(img, "reversed", 8, pipe=pipe)
    assert isinstance(out, Image.Image)
    assert out.size == (16, 16)
    # a random-weight roundtrip must actually change the pixels
    assert not np.array_equal(np.asarray(out), np.asarray(img))


# -- the CLI ---------------------------------------------------------------------


@pytest.fixture()
def image_dir(tmp_path):
    rng = np.random.default_rng(8)
    d = tmp_path / "in"
    d.mkdir()
    for i in range(2):
        Image.fromarray((rng.uniform(size=(24, 24, 3)) * 255).astype(np.uint8)).save(
            d / f"im{i}.png")
    (d / "notes.txt").write_text("not an image")
    return d


def test_cli_fixed_strength_equals_reference_cli(image_dir, tmp_path):
    """Host mode (``--host`` in the port, the reference's default): the same
    flags to both CLIs give the same directory name and the same files."""
    from gswm.cli import gs_distort as j_cli

    flags = ["--input_dir", str(image_dir), "--distortion_type", "noise",
             "--strength", "0.4", "--relative_strength", "--distortion_seed", "3"]
    gs_distort.main(flags + ["--host", "--output_dir_base", str(tmp_path / "t")])
    j_cli.main(flags + ["--output_dir_base", str(tmp_path / "j")])
    assert [p.name for p in (tmp_path / "t").iterdir()] == ["noise_0.2"]
    for name in ("im0.png", "im1.png"):
        got = np.asarray(Image.open(tmp_path / "t" / "noise_0.2" / name))
        want = np.asarray(Image.open(tmp_path / "j" / "noise_0.2" / name))
        np.testing.assert_array_equal(got, want)


def test_cli_sweeps_and_add2one(image_dir, tmp_path):
    out = tmp_path / "sweep"
    gs_distort.main(["--input_dir", str(image_dir), "--output_dir_base", str(out),
                     "--distortion_type", "brightness", "--sgstart", "0.1",
                     "--sgend", "0.35", "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == [
        "brightness_2.5", "brightness_4.0", "brightness_5.5"]
    out = tmp_path / "all"  # every enabled type of the compose-all table: rotation
    gs_distort.main(["--input_dir", str(image_dir), "--output_dir_base", str(out),
                     "--sgstart", "0.5", "--sgend", "0.55", "--host"])
    assert [p.name for p in out.iterdir()] == ["rotation_180.0"]
    out = tmp_path / "one"
    gs_distort.main(["--input_dir", str(image_dir), "--output_dir_base", str(out),
                     "--add2one"])
    assert [p.name for p in out.iterdir()] == ["rotation_180.0"]
    assert sorted(p.name for p in (out / "rotation_180.0").iterdir()) == [
        "im0.png", "im1.png"]


def test_cli_device_mode_runs_the_batched_attack(image_dir, tmp_path):
    """The default mode: the directory as one batch through ``device.apply``
    with a generator seeded by ``distortion_seed`` (here on the CPU, by
    name), through the function and through the flags."""
    out_dir = gs_distort.process_images_in_directory(
        str(image_dir), str(tmp_path / "d"), "erasing", strength=0.5,
        distortion_seed=9, device="cpu")
    assert Path(out_dir).name == "erasing_0.5"
    gs_distort.main(["--input_dir", str(image_dir), "--output_dir_base",
                     str(tmp_path / "f"), "--distortion_type", "erasing", "--strength",
                     "0.5", "--distortion_seed", "9", "--device", "cpu"])
    for n in ("im0.png", "im1.png"):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "f" / "erasing_0.5" / n)),
            np.asarray(Image.open(Path(out_dir) / n)))
    names = ["im0.png", "im1.png"]
    x = torch.from_numpy(to_tensor([Image.open(image_dir / n) for n in names],
                                   norm_type=None))
    want = dev.apply(x, "erasing", 0.5, generator=torch.Generator().manual_seed(9))
    for n, im in zip(names, to_pil(want.numpy(), norm_type=None)):
        np.testing.assert_array_equal(np.asarray(Image.open(Path(out_dir) / n)),
                                      np.asarray(im))


def test_attack_seed_is_the_same_in_every_process():
    """The reference keys each attack with ``hash(attack)``, which changes
    with PYTHONHASHSEED; the port's crc32 seed, and so its draws, do not."""
    code = ("import torch; from gswm_torch.eval.sweep import attack_seed; "
            "from gswm_torch.distortions import device as dev; "
            "s = attack_seed(5, 'noise'); "
            "g = torch.Generator().manual_seed(s); "
            "x = torch.full((1, 3, 8, 8), 0.5); "
            "print(s, hash('noise') % 2**31, "
            "dev.apply(x, 'noise', 0.1, generator=g).sum().item())")
    outs = []
    for hashseed in ("1", "2"):
        res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=120, check=True,
                             cwd=Path(__file__).resolve().parents[1],
                             env={**os.environ, "PYTHONHASHSEED": hashseed})
        outs.append(res.stdout.split())
    assert outs[0][0] == outs[1][0] and outs[0][2] == outs[1][2]
    assert outs[0][1] != outs[1][1]  # the reference's fold-in value moved
