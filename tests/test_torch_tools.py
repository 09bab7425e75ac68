"""The tile-sweep tools build each variant from the kernel's own source
with its constants replaced: every variant's replacement must land (a
constant that is not found would time the source's own shape under the
variant's name).  The sweeps themselves run only on the card."""

import re

import pytest

from sparknet_tpu_torch.ops import _build
from sparknet_tpu_torch.tools import comm_tiles, decode_tiles, lrn_tiles


@pytest.mark.parametrize("kernel,variant", [
    *(("K5", v) for v in lrn_tiles.FWD_VARIANTS),
    *(("K6", v) for v in lrn_tiles.BWD_VARIANTS)])
def test_lrn_tiles_variants_replace_the_kernels_constants(kernel, variant):
    threads, group, blocks, _ = variant
    src = lrn_tiles._variant_source(kernel, *variant)
    assert (f"{kernel}_THREADS = {threads}, {kernel}_G = {group}, "
            f"{kernel}_MB = {blocks};") in src
    other = "K6" if kernel == "K5" else "K5"  # left as it was
    line = rf"{other}_THREADS = \d+, {other}_G = \d+, {other}_MB = \d+;"
    own = (_build.SRC_DIR / "lrn.cu").read_text()
    assert re.search(line, src).group(0) == re.search(line, own).group(0)


@pytest.mark.parametrize("variant", comm_tiles.VARIANTS)
def test_comm_tiles_variants_replace_the_tile_map_constants(variant):
    tile, threads, unroll = variant
    src = comm_tiles._variant_source(*variant)
    for name, val in (("TILE", tile), ("THREADS", threads), ("UNROLL", unroll)):
        assert f"constexpr int {name} = {val};" in src


@pytest.mark.parametrize("variant", decode_tiles.VARIANTS)
def test_decode_tiles_variants_replace_the_kernels_constants(variant):
    split, threads, merge = variant
    src = decode_tiles._variant_source(*variant)
    for name, val in (("SPLIT", split), ("NT", threads),
                      ("MERGE_IN_KERNEL", merge)):
        assert f"constexpr int {name} = {val};" in src
    # built only for the timed head dims
    assert "FLASH_HEAD_DIMS(LAUNCH)" not in src
    assert "LAUNCH(64) LAUNCH(256)" in src
