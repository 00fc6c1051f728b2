"""Average coverage XMLs across replicates into per-mapper TSVs.

A copy of the JAX package's ``scripts/pull_averages.py``.

Reproduces the reference's scripts/fast_pull_averages.py: given a file
listing coverage_bestPerRead.xml paths (three replicates per mapper,
mapper name parsed from the ``.fa_<Mapper>/`` path segment), write a
TSV of replicate-averaged mismatch / identity / insertion / deletion
rates per mapper, skipping Realign-without-Em variants.

Usage: python -m nanopore_tpu_torch.scripts.pull_averages <xml_list> <out.tsv>
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET


def average_attrib(paths: list[str], attrib: str) -> float:
    vals = [
        float(ET.parse(p).getroot().attrib[attrib]) for p in paths
    ]
    return sum(vals) / len(vals)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    list_path, out_path = argv
    results: dict[str, list[str]] = {}
    for line in open(list_path):
        line = line.rstrip()
        if not line:
            continue
        mapper = line.split(".fa_")[1].split("/")[0]
        results.setdefault(mapper, []).append(line)

    with open(out_path, "w") as fh:
        fh.write("mapper\tavgMismatch\tavgIdentity\tAvgInsert\tAvgDelete\n")
        for mapper in sorted(results):
            if "Realign" in mapper and "Em" not in mapper:
                continue
            paths = results[mapper]
            fh.write(
                "\t".join(
                    [
                        mapper,
                        str(average_attrib(paths, "avgmismatchesPerReadBase")),
                        str(average_attrib(paths, "avgidentity")),
                        str(average_attrib(paths, "avginsertionsPerReadBase")),
                        str(average_attrib(paths, "avgdeletionsPerReadBase")),
                    ]
                )
                + "\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
