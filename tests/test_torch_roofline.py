"""The port's analytic roofline (``repro_torch.roofline.analysis``)
against ``repro.roofline.analysis`` on the CPU: the decode-state bytes a
slot, the memory-bound decode prediction (given the reference's ``HW``,
the formulas must agree to the byte) and model FLOPs for every assigned
architecture and input shape, and the H100 datasheet figures the port
keeps in its own ``HW``.  No hardware is read."""
import pytest

pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.configs import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.roofline import analysis as J  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

ARCHS = tuple(ASSIGNED_ARCHS) + ("fedmm-base", "fedmm-small")


def test_the_same_architectures_and_shapes():
    assert tuple(T_ARCHS) == tuple(ASSIGNED_ARCHS)
    assert sorted(INPUT_SHAPES) == sorted(J_SHAPES)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_bytes_roofline_and_flops_match_jax(arch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        for c in (1, 4096, shape.seq_len):
            assert A.decode_cache_bytes_per_slot(tcfg, c) == \
                J.decode_cache_bytes_per_slot(jcfg, c)
        kw = dict(n_slots=shape.global_batch, cache_len=shape.seq_len)
        assert A.decode_roofline(tcfg, hw=J.HW, **kw) == \
            J.decode_roofline(jcfg, hw=J.HW, **kw)
        for training in (False, True):
            assert A.model_flops(tcfg, shape, training=training) == \
                J.model_flops(jcfg, jshape, training=training)
    for dt in ("float32", "bfloat16", "float16"):
        assert A.decode_cache_bytes_per_slot(tcfg.with_(dtype=dt), 512) == \
            J.decode_cache_bytes_per_slot(jcfg.with_(dtype=dt), 512)


def test_h100_figures():
    """NVIDIA's datasheet figures for the H100 SXM 80 GB at 700 W, not
    v5e's: the default ``HW`` divides the step's bytes by 3.35e12 B/s."""
    assert A.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                    "nvlink_bw": 900e9, "hbm_bytes": 80 * 2 ** 30}
    cfg = get_config("fedmm-base")
    r = A.decode_roofline(cfg, n_slots=8, cache_len=1024)
    assert r["pred_step_s"] == r["step_bytes"] / 3.35e12
    assert r["param_bytes"] == cfg.param_count * 2
    assert r["cache_bytes_per_slot"] == 24 * 2 * 8 * 64 * 1024 * 2
    assert A._DTYPE_BYTES == J._DTYPE_BYTES
