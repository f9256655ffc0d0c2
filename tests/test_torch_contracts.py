"""The kernels' width contracts, checked when an engine is built
(``runtime/contracts.py``), as plain functions of the configuration on the
CPU: the narrow test configuration (16-wide heads) is refused in fast and
turbo mode, naming K1; the full-width configuration passes in every mode,
with and without each switch; parity mode is never refused; each contract
names its layer, kernel and switch; and an engine built for the card from
narrow weights raises at construction, before it touches the card, while a
CPU engine on the same weights builds.
"""
import dataclasses

import pytest

from mmdx_tpu_torch.checkpoints import bridge
from mmdx_tpu_torch.config import DiagnosisConfig
from mmdx_tpu_torch.runtime.contracts import check_kernel_contracts, first_unmet_contract

FULL = DiagnosisConfig()
SWITCHES = {"none": {}, "MMDX_TEXT_INT8": dict(text_int8=True),
            "MMDX_KV_INT8": dict(kv_int8=True), "MMDX_FUSED_LM_HEAD": dict(fused_lm_head=True),
            "MMDX_INT8_FUSED_BLOCKS": dict(int8_fused_blocks=(1, 2)),
            "all": dict(text_int8=True, kv_int8=True, fused_lm_head=True,
                        int8_fused_blocks=(1, 2))}


def _with(config, part, **kw):
    return dataclasses.replace(config, **{part: dataclasses.replace(getattr(config, part), **kw)})


@pytest.mark.parametrize("mode,switches", [("fast", {}), ("turbo", dict(text_int8=True))])
def test_narrow_heads_are_refused_naming_k1(mode, switches):
    with pytest.raises(ValueError, match="K1") as err:
        check_kernel_contracts(bridge.small_config(), mode, **switches)
    assert "text encoder" in str(err.value) and "64-wide heads" in str(err.value)
    assert f"{mode} mode" in str(err.value)


@pytest.mark.parametrize("name", list(SWITCHES))
@pytest.mark.parametrize("mode", ["fast", "turbo"])
def test_full_config_passes(mode, name):
    assert first_unmet_contract(FULL, mode, **SWITCHES[name]) is None
    fused = _with(FULL, "image", use_fused_bottleneck=True)
    assert first_unmet_contract(fused, mode, **SWITCHES[name]) is None


@pytest.mark.parametrize("config", [FULL, bridge.small_config()], ids=["full", "small"])
def test_parity_is_never_refused(config):
    assert first_unmet_contract(config, "parity", **SWITCHES["all"]) is None
    check_kernel_contracts(config, "parity", **SWITCHES["all"])


@pytest.mark.parametrize("config,switches,names", [
    (_with(FULL, "report", d_kv=32), {}, ("K4", "report decoder", "fast mode")),
    (_with(FULL, "generation", num_beams=16), {}, ("K3", "1-8 beams")),
    (_with(FULL, "generation", num_beams=16), dict(kv_int8=True), ("row 7", "MMDX_KV_INT8=1")),
    (_with(_with(FULL, "report", d_model=96, num_heads=1, d_kv=96), "report", vocab_size=256),
     dict(fused_lm_head=True), ("rows 10 and 11", "MMDX_FUSED_LM_HEAD=1")),
    (_with(FULL, "text", intermediate_size=3000), {}, ("K2", "widths in 64s")),
    (_with(FULL, "text", max_len=512, num_heads=24, use_flash_attention=True), {},
     ("row 9", "32 wide")),
    (FULL, dict(int8_fused_blocks=(5,)), ("row 13", "MMDX_INT8_FUSED_BLOCKS")),
    (_with(FULL, "image", img_size=4096), dict(int8_fused_blocks=(1,)),
     ("row 13", "does not fit")),
    (_with(_with(FULL, "image", img_size=4096), "image", use_fused_bottleneck=True), {},
     ("row 12", "use_fused_bottleneck")),
])
def test_each_contract_names_its_kernel(config, switches, names):
    why = first_unmet_contract(config, "turbo" if "int8_fused_blocks" in switches else "fast",
                               **switches)
    assert why is not None
    for name in names:
        assert name in why, (name, why)


def test_engine_on_the_card_refuses_narrow_weights_at_construction():
    """The check runs before the engine moves its model: a CUDA engine from
    the narrow configuration raises here, with no card; the same bundle
    builds a CPU engine."""
    from mmdx_tpu_torch.runtime.engine import InferenceEngine

    cfg = bridge.small_config()
    bundle = bridge.bundle_from_variables(bridge.random_state(cfg, 0), cfg)
    for mode in ("fast", "turbo"):
        with pytest.raises(ValueError, match="K1"):
            InferenceEngine(bundle, mode=mode, device="cuda")
    engine = InferenceEngine(bundle, mode="fast", device="cpu")
    assert engine.device.type == "cpu"
