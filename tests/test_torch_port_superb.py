"""SuperbSID's stages 1-3 of s3prl_tpu_torch vs s3prl_tpu (CPU) on a tiny
fake VoxCeleb1, through `Problem.run`, with the tiny trunk and the
tolerances of `test_torch_port_recipes` (the test accuracy equal, losses at
rtol 1e-5, the final probe parameters at atol 1e-6)."""

from test_torch_port_probe import tiny_pair, voxceleb1_layout  # noqa: F401 (fixture)
from test_torch_port_recipes import _run_both, _same_results


def test_superb_sid_stages_1_to_3_match_jax(tmp_path, tiny_pair):
    """SuperbSID on a fake VoxCeleb1 (three speakers): stage 0 writes the
    CSVs, stages 1-3 train (batch 4, two micro-batches an update) and
    evaluate in both packages."""
    prepare = voxceleb1_layout(tmp_path / "corpus")
    _run_both(tmp_path, tiny_pair, "SuperbSID", prepare_data=prepare,
              build_downstream={"hidden_size": 16}, build_batch_sampler={"batch_size": 4},
              train={"total_steps": 4, "log_step": 2, "eval_step": 2, "save_step": 2,
                     "gradient_accumulate": 2})
    _same_results(tmp_path)
