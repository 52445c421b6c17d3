"""AmsoftmaxSegmentExample of s3prl_tpu_torch vs s3prl_tpu (CPU), through
`Problem.run`: the x-vector with self-attentive pooling and AM-softmax,
then the segment evaluation (each test utterance cut into windows of 8,000
samples at a stride of 4,000, one upstream forward an utterance, the mean
of the unit-normalised segment embeddings) and the trials' EER / minDCF,
with the states and tolerances of test_torch_port_speaker_recipes.
"""

from test_torch_port_probe import tiny_pair  # noqa: F401 (fixture)
from test_torch_port_speaker_recipes import check_asv_recipe, same_states  # noqa: F401


def test_segment_eval_recipe_matches_jax(tmp_path, same_states):  # noqa: F811 (fixture)
    check_asv_recipe(tmp_path, same_states, "AmsoftmaxSegmentExample", {"am_weight"}, 5e-4)
