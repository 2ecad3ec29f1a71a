"""tests/test_torch_gptq.py's pack, moment and generation tests on the
small xLSTM model: its sites are 'stack/block_{b}/slstm/w_i', '.../w_z',
'.../ffn/up', '.../ffn/down', 'stack/block_{b}/mlstm/up_proj',
'.../down_proj' and 'lm_head', and its packs run kernel G's W8A16 step."""
import pytest

from tests.test_torch_gptq import (calibrate, test_collect_hessians_matches_jax,  # noqa: F401
                                   test_generate_on_a_gptq_pack_matches_jax, test_gptq_packs_match_jax,
                                   test_quantizer_without_moments_is_the_rtn_pack)


@pytest.fixture(scope="module")
def calibrated():
    return calibrate("xlstm")
