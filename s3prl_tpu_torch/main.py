"""CLI entry: `python -m s3prl_tpu_torch.main <ProblemName> [--config ...] [--a.b v]`
(port of s3prl_tpu/main.py; the reference's s3prl-main console script,
s3prl/main.py:6-26): resolve the problem class from the registry and hand
the remaining argv to its omni-config `main`. The recipes train on the
card; a trunk entry goes in ``--build_upstream.name``, e.g.

    python -m s3prl_tpu_torch.main CommonExample --target_dir exp/example \\
        --build_upstream.name hubert_large_ll60k \\
        --build_upstream.extra_conf "{'dtype': 'bf16', 'flash': True, 'quantize': True}"

The CTC recipes (SuperbASR, SuperbPR, SuperbSF, AsrExample) run the same
way, e.g. ``SuperbASR --prepare_data.librispeech /data/LibriSpeech``
(FLAC is read natively); a trained workspace transcribes one file with
``SuperbASR().inference(target_dir, config, "utt.flac")``.

Query-by-example (no training: features at B = 1, DTW on the card) and
the HEAR recipes run the same way, e.g.

    python -m s3prl_tpu_torch.main QbeDTW --target_dir exp/qbe \
        --prepare_data.quesst14 /data/quesst14Database \
        --build_upstream.name hubert_large_ll60k
    python -m s3prl_tpu_torch.main HearESC50 --target_dir exp/esc50 \
        --prepare_data.task_dir /data/hear/esc50-v2.0.0-full \
        --prepare_data.test_fold 0 --build_upstream.name hubert_large_ll60k

The SLU recipes (SluATIS, SluAudioSnips, MoseiSentiment, SluExample) too,
e.g. ``SluATIS --prepare_data.atis /data/atis``; a mel-domain upstream is
one more name, e.g. ``--build_upstream.name tera``.

Voice conversion (VcVcc2020, VcExample) trains the Taco2-AR decoder and
writes Griffin-Lim waves under ``<target_dir>/wav_hyp``, e.g.
``VcVcc2020 --prepare_data.vcc2020 /data/vcc2020``; its decoder needs an
upstream at the mels' 160-sample hop (the default ``fbank``).

Several cards: one process a card under ``torchrun``, whose environment
starts the process group (`parallel.distributed.initialize`; NCCL when each
rank has a card), and the trainer's ``train`` block sets the data- and
tensor-parallel ways, e.g.

    torchrun --nproc-per-node 4 -m s3prl_tpu_torch.main CommonExample \
        --target_dir exp/example --train.dp 2 --train.tp 2 \
        --build_upstream.name hubert_large_ll60k \
        --build_upstream.extra_conf "{'dtype': 'bf16', 'flash': True}"

(tp shards the upstream, which then takes ``quantize=False``.)
"""

from __future__ import annotations

import logging
import sys

from .parallel.distributed import initialize
from .problem import Problem


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    initialize()  # a no-op outside torchrun
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("available problems:", ", ".join(sorted(Problem._registry)))
        return
    cls = Problem.get_class_from_name(argv[0])
    return cls().main(argv[1:])


if __name__ == "__main__":
    main()
