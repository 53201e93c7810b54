"""The port's ``registry.py`` and ``data/val_stub.py`` against the JAX
package's: the same registry names, each bound to the port's class of the
same name, the same registry behaviour, and the same seeded arrays."""

import numpy as np
import pytest

from marconet_tpu import registry as jregistry
from marconet_tpu.data.val_stub import ValStubDataset as JaxValStub
from marconet_tpu_torch import registry as tregistry
from marconet_tpu_torch.data.val_stub import ValStubDataset

REGISTRIES = ("ARCHS", "DATASETS", "LOSSES", "MODELS")


@pytest.mark.parametrize("name", REGISTRIES)
def test_same_names_and_classes(name):
    got, want = getattr(tregistry, name), getattr(jregistry, name)
    assert got.name == want.name
    assert sorted(got._map) == sorted(want._map)
    for key, cls in got._map.items():
        assert cls.__module__.startswith("marconet_tpu_torch."), key
        assert cls.__name__ == want.get(key).__name__, key


def test_registry_behaviour():
    reg = tregistry.Registry("things")

    @reg.register
    class A:
        def __init__(self, x, y=0):
            self.x, self.y = x, y

    reg.register(A, name="alias")
    assert "A" in reg and "alias" in reg and "B" not in reg
    built = reg.build({"type": "alias", "x": 3}, y=4)
    assert isinstance(built, A) and (built.x, built.y) == (3, 4)
    with pytest.raises(KeyError, match="already registered"):
        reg.register(type("A", (), {}))
    with pytest.raises(KeyError, match=r"known: \['A', 'alias'\]"):
        reg.get("B")


def test_builds_the_val_stub_by_its_reference_name():
    ds = tregistry.DATASETS.build({"type": "ValDataset", "length": 2})
    assert isinstance(ds, ValStubDataset) and len(ds) == 2


@pytest.mark.parametrize("seed", [0, 7])
def test_val_stub_arrays_match_jax(seed):
    got, want = ValStubDataset(3, seed), JaxValStub(3, seed)
    assert len(got) == len(want) == 3
    for i in range(3):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w) == ["gt", "lq"]
        for k in g:
            assert g[k].dtype == w[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["gt"].shape == (128, 2048, 3)
    assert got[0]["lq"].shape == (32, 512, 3)
