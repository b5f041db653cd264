"""The inputs of the three ring cells, pinned: the layers that
``datagen.layers`` makes at the full configurations, and the reference's
pairs at each configuration's ``cpu_test`` cut, as sha256 digests. A
change to the generator or the reference that moves a cell's data or
answers fails here."""
import hashlib

import numpy as np
import pytest

from joinbench import datagen, harness, reference

#: (configuration, --seed) -> digest of ``datagen.layers``
LAYERS = {
    ("tiger-t1-t2", 1):
        "f6969cb28329f1946cef5a1aa26b8e8b4687f6daf99b3fa321015bf6b69b7311",
    ("tiger-t1-t2", 2718281828):
        "7fb539126efa8be5763b0f4691f9516632a774f08b827c6e14ee575160b31590",
    ("tiger-t2-t10", 1):
        "ca02cae4941cfaa163fc17a665adb180770ec734d7f259f2c12b3e3dd90e455c",
    ("tiger-t2-t10", 2718281828):
        "6acbe355b2dec6181b6df679348ef5a33c0dd89550606e1d6f8aea1a7723ad3f",
}
#: cell -> (pairs, digest of their keys) at the ``cpu_test`` cut
PAIRS = {
    "t1xt2-intersects": (930, "ffbd08258d3213bc5d54268e97d84262"
                              "f609322e9a5a522a313c10c53da1f32d"),
    "t2xt10-within": (81, "26c717202ef216c83abd25998cd88bf7"
                          "7ddd344167f75c545d61341853e7ffaf"),
    "t2xt10-selection": (189, "d8839eaac17ef55d4de5a36c3c103d07"
                              "2ef62744f8b372447c75bb9fd07724ce"),
}
SEED = 2**31 + 12345


def _config(name: str) -> dict:
    bench = harness.load_benchmark()
    work = next(w for w in bench["workloads"] if w["config"] == name)
    return harness.cell(work["name"], bench)["config_data"]


def _digest(layers: dict) -> str:
    h = hashlib.sha256()
    for side in ("r", "s"):
        verts, nverts = layers[side]
        h.update(repr(verts.shape).encode())
        h.update(np.ascontiguousarray(verts, np.float64).tobytes())
        h.update(np.ascontiguousarray(nverts, np.int64).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,seed", list(LAYERS))
def test_layers_are_pinned(config, seed):
    got = _digest(datagen.layers(_config(config), seed))
    assert got == LAYERS[config, seed]


@pytest.mark.parametrize("cell", list(PAIRS))
def test_reference_pairs_are_pinned(cell):
    spec = harness.cell(cell)
    conf = {**spec["config_data"], **spec["config_data"]["cpu_test"]}
    L = datagen.layers(conf, SEED)
    keys = reference.pair_keys(
        reference.join(*L["r"], *L["s"], spec["traffic_data"]["predicate"]),
        len(L["s"][1]))
    assert (len(keys), hashlib.sha256(keys.tobytes()).hexdigest()) \
        == PAIRS[cell]
