"""Query-by-example spoken term detection, SUPERB QbE (port of s3prl_tpu/
problem/qbe.py).

Behavioral spec from the reference (s3prl/downstream/quesst14_dtw; no
training: extract frozen upstream features for queries and documents, DTW
every (query, doc) pair, write per-query score lists for the official MTWV
scorer): stages here are prepare (CSV of queries + docs) and extract +
score, which writes the benchmark-format score list. MTWV needs the
official ground-truth tooling, which stays outside.

Each utterance is extracted alone (B = 1), cut at ``max_secs``, so the
frozen forward sees every length from a short query to a 30-s document;
the chosen layer's features stay on the upstream's device, where
`ops.dtw.qbe_scores` scores every pair. The recipes' default upstream
(``fbank``) is not ported: a run names a trunk entry in ``build_upstream``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from .base import Problem
from ..data.dataset import _CsvDataset
from ..nn.upstream import SUpstream
from ..ops.dtw import qbe_scores

logger = logging.getLogger(__name__)


def pad_features(feats):
    """[T_i, D] tensors -> ([N, T, D] zero-padded, [N] lengths) on their device."""
    T = max(f.shape[0] for f in feats)
    out = feats[0].new_zeros((len(feats), T, feats[0].shape[-1]))
    for i, f in enumerate(feats):
        out[i, : f.shape[0]] = f
    return out, torch.tensor([f.shape[0] for f in feats], device=out.device)


class QbeDTW(Problem):
    STAGES = ["prepare_data", "score_stage"]

    def default_config(self) -> dict:
        return {
            "target_dir": "???",
            "prepare_data": {"quesst14": "???", "split": "dev"},
            "build_upstream": {"name": "fbank"},
            "layer": -1,  # which upstream layer to use for matching
            "max_secs": 30.0,
        }

    def build_upstream(self, name: str = "fbank", **kwargs) -> SUpstream:
        return SUpstream(name, **kwargs)

    def prepare_data(self, workspace: Path, config: dict):
        root = Path(config["prepare_data"]["quesst14"])
        split = config["prepare_data"].get("split", "dev")
        queries = sorted((root / f"{split}_queries").glob("*.wav"))
        docs = sorted((root / "Audio").glob("*.wav"))
        pd.DataFrame(
            [dict(id=q.stem, wav_path=str(q)) for q in queries]
        ).to_csv(workspace / "queries.csv", index=False)
        pd.DataFrame(
            [dict(id=d.stem, wav_path=str(d)) for d in docs]
        ).to_csv(workspace / "docs.csv", index=False)

    def _extract(self, upstream: SUpstream, csv_path, layer: int, max_secs: float):
        """Each utterance's layer-`layer` features [n, D] f32 on the
        upstream's device, at B = 1."""
        ds = _CsvDataset(csv_path)
        dev = upstream.upstream.device
        feats, names = [], []
        for i in range(len(ds)):
            row = ds.df.iloc[i]
            wav = ds._load_wav(row)[: int(max_secs * 16000)]
            hs, h_lens = upstream(torch.from_numpy(wav[None]).to(dev),
                                  torch.tensor([len(wav)], device=dev))
            feats.append(hs[layer, 0, : int(h_lens[0])].float())
            names.append(str(row["id"]))
        return feats, names

    def score_stage(self, workspace: Path, config: dict):
        upstream = self.build_upstream(**config.get("build_upstream", {"name": "fbank"}))
        layer = config.get("layer", -1)
        max_secs = config.get("max_secs", 30.0)
        q_feats, q_names = self._extract(upstream, workspace / "queries.csv", layer, max_secs)
        d_feats, d_names = self._extract(upstream, workspace / "docs.csv", layer, max_secs)
        scores = qbe_scores(*pad_features(q_feats), *pad_features(d_feats)).cpu().numpy()
        rows = []
        for i, qn in enumerate(q_names):
            for j, dn in enumerate(d_names):
                rows.append(dict(query=qn, doc=dn, score=float(scores[i, j])))
        pd.DataFrame(rows).to_csv(workspace / "scores.csv", index=False)
        logger.info(f"wrote {len(rows)} (query, doc) scores")
        return {"num_queries": len(q_names), "num_docs": len(d_names)}


class QbeExample(QbeDTW):
    """Smoke test: queries embedded verbatim inside docs must rank first."""

    def default_config(self) -> dict:
        cfg = super().default_config()
        cfg["prepare_data"] = {}
        return cfg

    def prepare_data(self, workspace: Path, config: dict):
        from ..util.pseudo_data import _write_wav

        rng = np.random.RandomState(0)
        (workspace / "wavs").mkdir(parents=True, exist_ok=True)
        query = rng.randn(4000).astype(np.float32) * 0.1
        doc_match = rng.randn(24000).astype(np.float32) * 0.1
        doc_match[8000:12000] = query
        doc_other = rng.randn(24000).astype(np.float32) * 0.1
        rows_q, rows_d = [], []
        for name, wav, rows in [
            ("q0", query, rows_q), ("doc_match", doc_match, rows_d), ("doc_other", doc_other, rows_d),
        ]:
            p = workspace / "wavs" / f"{name}.wav"
            _write_wav(p, wav)
            rows.append(dict(id=name, wav_path=str(p)))
        pd.DataFrame(rows_q).to_csv(workspace / "queries.csv", index=False)
        pd.DataFrame(rows_d).to_csv(workspace / "docs.csv", index=False)
