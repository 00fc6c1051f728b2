"""XML pretty-printing matching the bioio.prettyXml output style.

The reference writes every analysis result through sonLib's prettyXml
(e.g. substitutions.py:72, coverage.py:148); downstream meta-analyses parse
the files back with ElementTree, so only well-formedness and the
element/attribute schema matter — we indent with two spaces.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET


def _indent(elem: ET.Element, level: int = 0) -> None:
    pad = "\n" + "  " * level
    if len(elem):
        if not elem.text or not elem.text.strip():
            elem.text = pad + "  "
        for child in elem:
            _indent(child, level + 1)
            if not child.tail or not child.tail.strip():
                child.tail = pad + "  "
        if not elem[-1].tail or not elem[-1].tail.strip():
            elem[-1].tail = pad
    elif level and (not elem.tail or not elem.tail.strip()):
        elem.tail = pad


def pretty_xml(root: ET.Element) -> str:
    _indent(root)
    return ET.tostring(root, encoding="unicode") + "\n"
