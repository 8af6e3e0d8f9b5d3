"""The port's engine against the JAX package's over the slot and paged
pools of every family (``tests/test_paged.py``'s parity sweep).

The port's engine runs the JAX package's model (``_torch_port
.jax_model_in_port_engine``), so both engines see the same logits: its
machinery — admission, the slot and paged pools of every family, sampling
keys, defrag — must give the JAX engine's streams bit for bit at k in
{1, 4, 16}, greedy and sampled, on the slot and the paged pool. The whole
port (its own model), the prefix cache and the pools are in
``tests/test_torch_prefix.py``.
"""
import pytest

from _torch_port import (FAMILY_ARCHS, jax_engine_streams,
                         port_engine_streams)


# ------------------------------------------------------------------ parity --
@pytest.mark.parametrize("page_size", [None, 5], ids=["slot", "paged"])
@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_engine_machinery_matches_jax_engine(name, mode, k, page_size):
    """The port's engine, running JAX's model, gives the JAX engine's
    streams bit for bit; the paged pool returns every page."""
    sampled = mode == "sampled"
    got, eng, _ = port_engine_streams(name, sampled, k=k, jax_model=True,
                                      page_size=page_size)
    assert got == jax_engine_streams(name, sampled, page_size=page_size)
    s = eng.stats
    assert s.steps == s.syncs * k and s.retired == 5
    if page_size is not None and eng.cfg.family != "ssm":
        assert eng.paged
        assert eng.pool.live_page_count() == 0
        assert eng.pool.free_page_count == eng.pool.num_pages - 1
    else:
        # a pure SSM has no pageable leaves and keeps the slot pool
        assert not eng.paged
