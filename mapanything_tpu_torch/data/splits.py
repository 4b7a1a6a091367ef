"""Train/val/test scene-split rules and scene-list materialization; the
counterpart of mapanything_tpu/data/splits.py.

The reference ships 1,734 lines of materialized split tables
(reference mapanything/datasets/utils/data_splits.py) that its
preprocessing uses to write the `{stem}_scene_list_{split}.npy` files the
datasets load. The tables decompose into three kinds of rule, which this
module keeps PROCEDURAL so they apply to whatever scene inventory exists
on disk:

  * hash rules — BlendedMVS: scene names are `{seqh:08x}{seql:016x}`; val
    is `seql % 10 == 0`, train the rest (the DUSt3R split logic quoted at
    data_splits.py:18-32 — the 1,500-line literal list is just this rule
    materialized);
  * named lists — published protocol constants carried verbatim
    (TartanAir V2 val/test environments, MegaDepth + Spring DUSt3R val
    scenes, data_splits.py:1559-1602; the curated ScanNetPP-V2 val/test
    benchmark lists :1640-1700; ETH3D is all-test :1725-1734);
  * fraction rules — MPSD's 95/5 (:1603-1616) and, for corpora with no
    published list, a deterministic name-hash fraction. DL3DV's val split
    is the external DL3DV-Benchmark CSV in the reference too
    (:1709-1723) — `dl3dv_benchmark_rule()` loads a local copy.

`build_scene_lists` writes the same `.npy` files `data/wai_datasets.py`
reads, so splits materialize per-corpus exactly like the reference's
preprocessing step.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

SPLITS = ("train", "val", "test")


def _name_hash_unit(name: str) -> float:
    """Deterministic [0, 1) hash of a scene name (stable across runs and
    machines, unlike Python's salted hash())."""
    h = hashlib.sha1(name.encode()).digest()
    return int.from_bytes(h[:8], "big") / 2**64


@dataclass(frozen=True)
class SplitRule:
    """Per-dataset split assignment.

    Priority: explicit `test_scenes`/`val_scenes` membership, then
    `all_test`, then the BlendedMVS hex rule, then the hash fraction.
    """

    val_scenes: tuple = ()
    test_scenes: tuple = ()
    all_test: bool = False
    blendedmvs_hex: bool = False
    val_fraction: float = 0.1

    def assign(self, scene: str) -> str:
        if scene in self.test_scenes:
            return "test"
        if scene in self.val_scenes:
            return "val"
        if self.all_test:
            return "test"
        if self.blendedmvs_hex:
            try:
                seql = int(scene[8:], 16)
                return "val" if seql % 10 == 0 else "train"
            except ValueError:
                pass  # non-conforming name: fall through to the hash rule
        if self.val_scenes or self.test_scenes:
            return "train"  # named-list datasets: everything else trains
        return ("val" if _name_hash_unit(scene) < self.val_fraction
                else "train")


# Registry keyed like data/wai_datasets.WAI_DATASETS. Published constants
# cited to the reference lines they reproduce.
SPLIT_RULES: Dict[str, SplitRule] = {
    "blendedmvs": SplitRule(blendedmvs_hex=True),  # data_splits.py:18-32
    "tav2_wb": SplitRule(  # data_splits.py:1559-1580
        val_scenes=("EndofTheWorld", "HongKong", "WesternDesertTown"),
        test_scenes=("DesertGasStation", "OldScandinavia", "PolarSciFi",
                     "Sewerage", "Supermarket"),
    ),
    "megadepth": SplitRule(  # data_splits.py:1582-1592 (DUSt3R val)
        val_scenes=("0015_0", "0015_1", "0022_0"),
    ),
    "spring": SplitRule(val_scenes=("0013", "0023", "0037")),  # :1594-1601
    "mpsd": SplitRule(val_fraction=0.05),  # :1603-1616 (95/5)
    "eth3d": SplitRule(all_test=True),  # :1725-1734
    # ScanNetPP: the reference pins literal curated V2-only val/test scene
    # lists (data_splits.py:1640-1700; category-b protocol constants,
    # carried verbatim — the dense-N-view benchmark protocol is defined
    # OVER this exact test split). Everything else trains.
    "scannetpp": SplitRule(
        val_scenes=(  # data_splits.py:1641-1672
            "1c7a683c92", "2a1b555966", "3a43c7b8d2", "4aef651da7",
            "06bc6d1b24", "7f22d5ef1b", "7f77abce34", "8ea517a2fc",
            "29c7afafed", "41eb967018", "77b40ce601", "086f09d6e3",
            "307e3262f1", "639f2c4d5a", "894dbd41f1", "898a7dfd0c",
            "2779f8f9e2", "151178afd7", "182932a4f3", "635852d56e",
            "9906136b57", "af112b8903", "b0f057c684", "b37177e6c8",
            "b119249da7", "be8367fcbe", "c8fc01c453", "e1fb8626c8",
            "e2caaaf5b5", "fe3fc057a1",
        ),
        test_scenes=(  # data_splits.py:1674-1700
            "0e900bcc5c", "0eba3981c9", "1cbb105c6a", "3c8d535d49",
            "5d902f1593", "6bd39ac392", "6c14d5fd01", "7c31a42404",
            "9bfbc75700", "13b4efaf62", "062e5a23a6", "95b9971d01",
            "246fe09e98", "637a27d04b", "725b8f0cba", "413085a827",
            "696317583f", "a4c043ac48", "a9e4791c7e", "b0b004c40f",
            "c3bc5e82c5", "c31ebd4b22", "cba701332a", "cc5ea8026c",
            "cec8312f4e", "e3b3b0d0c7", "e667e09fe6", "eaa6c90310",
            "f9397af4cb", "fb893ffaf3",
        ),
    ),
    # DL3DV: the reference does NOT materialize a list — its val split IS
    # the external DL3DV-Benchmark CSV (data_splits.py:1709-1723 stores a
    # "load <huggingface CSV url>" instruction). Same contract here:
    # dl3dv_benchmark_rule() builds the rule from a local copy of that CSV
    # (the CSV is not fetched); without one, the hash fraction
    # below is an explicit, documented approximation.
}
DEFAULT_RULE = SplitRule()


def dl3dv_benchmark_rule(benchmark_csv: str) -> SplitRule:
    """Build the DL3DV split rule from a local copy of the official
    DL3DV-Benchmark metadata CSV (the file the reference's split table
    points at, data_splits.py:1718-1722: benchmark-meta.csv's `hash`
    column names the benchmark scenes, which are the val split).

    Register it with ``SPLIT_RULES["dl3dv"] = dl3dv_benchmark_rule(path)``
    before materializing scene lists.
    """
    import csv

    names: List[str] = []
    with open(benchmark_csv, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{benchmark_csv}: empty CSV")
        col = "hash" if "hash" in reader.fieldnames else reader.fieldnames[0]
        for row in reader:
            name = (row.get(col) or "").strip()
            if name:
                names.append(name)
    if not names:
        raise ValueError(f"{benchmark_csv}: no scene names found")
    return SplitRule(val_scenes=tuple(names))


def _resolve_rule(dataset: str, rule: Optional[SplitRule],
                  for_benchmark: bool) -> SplitRule:
    if rule is not None:
        return rule
    if dataset in SPLIT_RULES:
        return SPLIT_RULES[dataset]
    if for_benchmark:
        # fail-closed: benchmark scene selection must never silently fall
        # back to the hash-fraction approximation — for DL3DV the protocol
        # split IS the external benchmark CSV (reference
        # data_splits.py:1709-1723); register it first via
        # SPLIT_RULES["dl3dv"] = dl3dv_benchmark_rule(csv_path). Training
        # may keep the documented fallback (for_benchmark=False).
        raise LookupError(
            f"no registered split rule for dataset {dataset!r}: benchmark "
            "scene selection refuses the hash-fraction fallback (for "
            "dl3dv, register dl3dv_benchmark_rule(<benchmark-meta.csv>) "
            "in SPLIT_RULES first)")
    return DEFAULT_RULE


def assign_split(dataset: str, scene: str,
                 rule: Optional[SplitRule] = None,
                 for_benchmark: bool = False) -> str:
    """Split name ("train"/"val"/"test") for one scene.

    ``for_benchmark=True`` refuses datasets without a registered protocol
    rule instead of approximating with the hash fraction.
    """
    rule = _resolve_rule(dataset, rule, for_benchmark)
    return rule.assign(scene)


def split_scenes(dataset: str, scenes: Iterable[str],
                 rule: Optional[SplitRule] = None,
                 for_benchmark: bool = False) -> Dict[str, List[str]]:
    """Partition a scene inventory into the three splits."""
    rule = _resolve_rule(dataset, rule, for_benchmark)
    out: Dict[str, List[str]] = {s: [] for s in SPLITS}
    for scene in scenes:
        out[rule.assign(scene)].append(scene)
    return out


def build_scene_lists(
    dataset: str,
    scenes: Sequence[str],
    metadata_dir: str,
    metadata_stem: Optional[str] = None,
    rule: Optional[SplitRule] = None,
    for_benchmark: bool = False,
) -> Dict[str, str]:
    """Materialize `{stem}_scene_list_{split}.npy` files under
    `{metadata_dir}/{split}/` — the exact layout `WAIDataset._load_scene_list`
    reads. Returns {split: path} for non-empty splits."""
    stem = metadata_stem or dataset
    parts = split_scenes(dataset, scenes, rule, for_benchmark=for_benchmark)
    paths = {}
    for split, names in parts.items():
        if not names:
            continue
        d = os.path.join(metadata_dir, split)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{stem}_scene_list_{split}.npy")
        np.save(path, np.asarray(sorted(names)))
        paths[split] = path
    return paths
