"""Content-addressed fingerprints of the cacheable plan nodes.

Counterpart of ``avenir_tpu/plan/fingerprint.py``; every digest equals the
JAX package's for the same files and keys (sha256 over sorted JSON,
``utils/resume.job_fingerprint``). A staged-table fingerprint covers all
that can change the staged table: the input file facts (name, size,
mtime of each part file), the schema file's content, and every
encode-affecting key, the bad-row policy keys (``on.bad.row``,
``max.bad.fraction``, ``quarantine.dir``, which decide the rows that
survive) and the feed bucket keys included.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, List, Optional

from avenir_tpu_torch.utils.resume import job_fingerprint

# the JAX package's bucket floor: part of its staged shape, so part of the
# fingerprint of a bucketed table (the digests stay the JAX package's)
from avenir_tpu_torch.parallel.pipeline import BUCKET_FLOOR


def digest(parts: Dict[str, Any]) -> str:
    """sha256 hex over the sorted-JSON encoding of ``parts``."""
    return job_fingerprint(parts)


def file_facts(path: str) -> List[List[Any]]:
    """(basename, size, mtime_ns) per input file — for a part dir, every
    part file in the same sorted walk the loaders use. mtime is included
    on top of the resume-journal's (name, size) pair: an in-place edit
    that keeps the byte count must still miss the cache."""
    from avenir_tpu_torch.utils.dataset import part_file_paths
    paths = part_file_paths(path) if os.path.isdir(path) else [path]
    out = []
    for p in paths:
        st = os.stat(p)
        out.append([os.path.basename(p), st.st_size, st.st_mtime_ns])
    return out


def content_hash(path: str) -> str:
    """sha256 of a (small) file's bytes — schemas, not data files."""
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def encode_component(conf, *, with_labels: bool) -> Dict[str, Any]:
    """The encode-affecting config keys, one reading shared by every
    verb builder so NB's train-table fingerprint equals KNN's (that
    equality IS the chained-verbs cache hit)."""
    return {
        "delim": conf.get("field.delim.regex", ","),
        "unseen": conf.get("unseen.value.handling", "error"),
        "with_labels": bool(with_labels),
        "fit_data": (file_facts(conf.get("featurizer.fit.data.path"))
                     if conf.get("featurizer.fit.data.path") else None),
        # bad-row policy: decides which rows survive encoding on the
        # resilient paths: a changed policy must miss, never hit
        "on_bad_row": conf.get("on.bad.row", "raise"),
        "max_bad_fraction": conf.get_float("max.bad.fraction", 0.1),
        "quarantine_dir": conf.get("quarantine.dir"),
    }


def staged_table_fingerprint(conf, in_path: str, *, with_labels: bool,
                             feed_chunk_rows: int = 0,
                             bucketed: bool = False,
                             fit_fingerprint: Optional[str] = None) -> str:
    """Fingerprint of one encoded+staged table.

    ``feed_chunk_rows``/``bucketed`` cover the feed bucket sizes: a
    bucket-padded or feed-chunked staging has different device shapes
    than a plain one, so the keys that select it are content.
    ``fit_fingerprint`` chains a dependent table (KNN's test table is
    encoded through the TRAIN-fitted featurizer) to its fit source.
    """
    schema_path = conf.get_required("feature.schema.file.path")
    return digest({
        "v": 1,
        "node": "staged-table",
        "input": file_facts(in_path),
        "schema": content_hash(schema_path),
        "encode": encode_component(conf, with_labels=with_labels),
        "stage": {"feed_chunk_rows": int(feed_chunk_rows),
                  "bucket_floor": BUCKET_FLOOR if bucketed else None},
        "fit": fit_fingerprint,
    })
