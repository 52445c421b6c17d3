"""SuperbPR and SuperbSF of s3prl_tpu_torch vs s3prl_tpu (CPU) through
`Problem.run`, on the tiny trunk, with test_torch_port_asr_recipes'
harness and tolerances: SuperbPR on AsrExample's pseudo audio, SuperbSF on
a tiny Audio SNIPS tree. SuperbPR's losses and gradient norms at rtol
1e-4 and its parameters at atol 1e-4 (lr / 100): its Adam rate is 1e-2,
so the weights whose gradient is within rounding of zero (which move by
the rounding's sign) move 100 times further than at AsrExample's 1e-4,
and after its first update the loss, the gradient norm and the second
update follow (measured: 2.8e-5 and 2.5e-5 apart, and 6.6e-5 on 8% of an
input kernel's weights).
"""

import numpy as np

import s3prl_tpu.problem as jax_problem
import s3prl_tpu_torch.problem as port_problem
from test_torch_port_asr_recipes import SMALL, TRAIN, _pseudo, _recipes, _run_both, _same_results
from test_torch_port_probe import tiny_pair  # noqa: F401 (fixture)


def test_superb_pr_matches_jax(tmp_path, tiny_pair):
    """SuperbPR's configuration (Adam 1e-2, two micro-batches an update,
    the phoneme tokenizer over the transcripts' space-split words) on the
    pseudo data: PER / WER / CER equal."""
    recipes = _recipes((_pseudo("SuperbPR", jax_problem), _pseudo("SuperbPR", port_problem)),
                       tiny_pair)
    _run_both(tmp_path, recipes, prepare_data={"num_train": 6, "num_valid": 2, "num_test": 2},
              build_downstream=SMALL, build_batch_sampler={"batch_size": 2},
              train={**TRAIN, "total_steps": 4})
    _same_results(tmp_path, ("per", "wer", "cer"), lr=1e-2, accumulate=2, rtol=1e-4)
    assert "gradient_accumulate" in recipes[1].default_config()["train"]


def _snips_tree(root):
    """Audio SNIPS-shaped: wavs under train / valid / test by speaker and
    the IOB file (tab layout)."""
    from s3prl_tpu_torch.util.pseudo_data import _write_wav

    rng = np.random.RandomState(2)
    sents = [("BOS play jazz now EOS", "O O B-genre O O"),
             ("BOS wake me at six am EOS", "O O O O B-time I-time O"),
             ("BOS rain in york EOS", "O O O B-city O")]
    lines = []
    for split, spks in (("train", ["Ivy", "Joey", "Salli"]), ("valid", ["Amy"]),
                        ("test", ["Brian", "Emma"])):
        for spk in spks:
            d = root / split / spk
            d.mkdir(parents=True)
            for i in range(2):
                uid = f"{spk}-snips-{split}-{i}"
                _write_wav(d / f"{uid}.wav", (rng.randn(int(16000 * rng.uniform(0.4, 0.9)))
                                              * 0.1).astype(np.float32))
                sent, iob = sents[(i + len(lines)) % len(sents)]
                lines.append(f"{uid} {sent}\t{iob}")
    (root / "all.iob.snips.txt").write_text("\n".join(lines) + "\n")
    return root


def test_superb_sf_matches_jax(tmp_path, tiny_pair):
    """SuperbSF on a tiny Audio SNIPS tree: character + slot tokenizer,
    SlotFillingCTCTask; slot-type F1 and slot-value CER / WER equal."""
    root = _snips_tree(tmp_path / "snips")
    recipes = _recipes((jax_problem.SuperbSF, port_problem.SuperbSF), tiny_pair)
    _run_both(tmp_path, recipes, prepare_data={"snips": str(root)}, build_downstream=SMALL,
              build_batch_sampler={"batch_size": 2}, train=TRAIN)
    _same_results(tmp_path, ("slot_type_f1", "slot_value_cer", "slot_value_wer"), lr=1e-4)
