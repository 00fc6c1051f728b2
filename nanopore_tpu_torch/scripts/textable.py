"""LaTeX table helpers.

A copy of the JAX package's ``scripts/textable.py``.

Reproduces the reference's scripts/tex.py: sideways-table preliminaries,
multi-column/multi-row header lines, rows, figures — used by
variant_table to emit the supplementary SNV tables.
"""

from __future__ import annotations


def write_document_preliminaries(fh) -> None:
    fh.write("\\documentclass{article}\n")
    fh.write("\\usepackage{rotating}\n\\usepackage{multirow}\n")
    fh.write("\\begin{document}\n\n")


def write_document_end(fh) -> None:
    fh.write("\\end{document}\n")


def write_preliminaries(column_number: int, fh) -> None:
    fh.write("\\begin{sidewaystable}[h!]\n\\centering\n")
    fh.write("\\begin{tabular}{%s}\n" % (" ".join(["c"] * column_number)))
    fh.write("\\hline\n")


def write_end(fh, table_label: str, caption: str) -> None:
    fh.write("\\end{tabular}\n")
    fh.write("\\caption{%s}\n" % caption)
    fh.write("\\label{%s}\n" % table_label)
    fh.write("\\end{sidewaystable}\n\n")


def write_row(entries, fh) -> None:
    fh.write("%s \\\\\n" % " & ".join(str(e) for e in entries))


def write_line(column_number: int, row_number: int, entries, fh,
               trailing_lines: int = 1) -> None:
    """Multi-row/column header cells: entries are
    (name, x1, x2, y1, y2) spans (tex.py:46-72)."""
    updated = []
    for name, x1, x2, y1, y2 in entries:
        span_rows = y2 - y1 + 1
        updated.append((y1, x1, x2, name, span_rows, y2 - y1 == 0))
        yy1, yy2 = y1, y2
        while yy2 - yy1 > 0:
            yy1 += 1
            updated.append((yy1, x1, x2, "", span_rows, yy2 - yy1 == 0))
    updated.sort(key=lambda e: (e[0], e[1]))
    start = True
    current_row = 0
    clines: list[tuple[int, int]] = []
    for y1, x1, x2, name, span_rows, cline in updated:
        if y1 != current_row:
            fh.write(
                " \\\\ %s\n"
                % " ".join(
                    "\\cline{%i-%i}" % (x3 + 1, x4 + 1) for x3, x4 in clines
                )
            )
            current_row = y1
            clines = []
        elif not start:
            fh.write(" & ")
        start = False
        if cline:
            clines.append((x1, x2))
        fh.write(
            "\\multicolumn{%i}{c}{\\multirow{%i}{*}{%s}}"
            % (x2 - x1 + 1, span_rows, name)
        )
    fh.write(" \\\\\n")
    for _ in range(trailing_lines):
        fh.write("\\hline\n")


def write_figure(fh, image_file: str, caption: str, label: str,
                 width: int = 10) -> None:
    fh.write("\\clearpage\n")
    fh.write(
        "\\begin{figure}[h!]\n\\begin{center}\n"
        "\\includegraphics[width=%scm]{%s}\n\\caption{%s}\n\\label{%s}\n"
        "\\end{center}\n\\end{figure}\n\n" % (width, image_file, caption, label)
    )
