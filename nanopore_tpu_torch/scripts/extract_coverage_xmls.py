"""Concatenate per-read stats from coverage XML replicates.

A copy of the JAX package's ``scripts/extract_coverage_xmls.py``.

Reproduces the reference's scripts/extract_from_multiple_coverage_xmls.py:
pool the per-read readAlignmentCoverage children of several coverage
XMLs into a line-per-statistic text file (length / identity /
insertions / deletions / mismatches).

Usage: python -m nanopore_tpu_torch.scripts.extract_coverage_xmls \\
           <xml> [<xml> ...] <out.txt>
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    *xml_paths, out_path = argv
    columns = {
        "length": [],
        "identity": [],
        "insertions": [],
        "deletions": [],
        "mismatches": [],
    }
    attrs = {
        "length": "readLength",
        "identity": "identity",
        "insertions": "insertionsPerReadBase",
        "deletions": "deletionsPerReadBase",
        "mismatches": "mismatchesPerReadBase",
    }
    for path in xml_paths:
        root = ET.parse(path).getroot()
        for child in root:
            for key, attrib in attrs.items():
                if attrib in child.attrib:
                    columns[key].append(child.attrib[attrib])
    with open(out_path, "w") as fh:
        for key in ("length", "identity", "insertions", "deletions",
                    "mismatches"):
            fh.write(key + " " + " ".join(columns[key]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
