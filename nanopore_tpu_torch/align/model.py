"""The 5-state asymmetric pair-HMM model: parameters, file codecs, math.

Replaces the ``cactus_expectationMaximisation.Hmm`` class surface the
reference uses (loadHmm/write/stateNumber/emissions/likelihood,
reference nanopore/analyses/utils.py:3-4,611-629) and keeps the
on-disk formats bit-compatible with the shipped trained models
(reference nanopore/mappers/blasr_hmm_{0,20,40}.txt):

- text format line 1: ``<modelTypeInt> <25 transition probs row-major>
  <likelihood>`` (27 whitespace-separated fields),
- text format line 2: ``<80 emission probs>`` = 5 states x 16 (refBase*4 +
  readBase, bases ordered ACGT),
- XML flavour (``hmm.txt.xml``): ``<transition from to avg std>``,
  ``<emission state x y avg std>`` and per-trial ``<hmm
  runningLikelihoods=...>`` children (consumed by reference
  analyses/hmm.py:31-47,82-84).

State order. The reference is internally inconsistent about states 3/4
(utils.py:617 treats {2,4} as insert states while analyses/hmm.py:27-28
labels 3 "long insert" / 4 "long delete").  We follow utils.py — the side
whose math matters for EM post-processing:

    0 = match, 1 = short delete, 2 = short insert,
    3 = long delete, 4 = long insert

Delete states {1,3} consume a reference base; insert states {2,4} consume a
read base; match consumes both.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass, field as dataclass_field

SYMBOL_NUMBER = 4  # cactus_expectationMaximisation.SYMBOL_NUMBER (utils.py:4)
NUM_STATES = 5

MATCH, SHORT_DELETE, SHORT_INSERT, LONG_DELETE, LONG_INSERT = range(5)
DELETE_STATES = (SHORT_DELETE, LONG_DELETE)
INSERT_STATES = (SHORT_INSERT, LONG_INSERT)

_BASES = "ACGT"


@dataclass
class PairHmmModel:
    """Parameters of the five-state asymmetric pair HMM.

    transitions: (5, 5) float64, row = from-state, col = to-state.
    emissions:   (5, 16) float64, flattened (refBase, readBase) per state.
    """

    transitions: np.ndarray
    emissions: np.ndarray
    likelihood: float = 0.0
    model_type: int = 1  # field 0 of the text format ("fiveStateAsymmetric")
    running_likelihoods: list[list[float]] = dataclass_field(
        default_factory=list
    )  # per-trial EM likelihood traces, for the XML flavour

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @staticmethod
    def default() -> "PairHmmModel":
        """A reasonable stock model (used when no --loadHmm is given).

        Stands in for cactus_realign's built-in model: moderate gap open,
        sticky long gaps, 90%-identity match emissions.
        """
        t = np.array(
            [
                # M      shortD  shortI  longD    longI
                [0.90, 0.035, 0.035, 0.015, 0.015],  # from match
                [0.50, 0.50, 0.0, 0.0, 0.0],  # from short delete
                [0.50, 0.0, 0.50, 0.0, 0.0],  # from short insert
                [0.05, 0.0, 0.0, 0.95, 0.0],  # from long delete
                [0.05, 0.0, 0.0, 0.0, 0.95],  # from long insert
            ],
            dtype=np.float64,
        )
        match = np.full((4, 4), (0.1 / 3) * 0.25, dtype=np.float64)
        np.fill_diagonal(match, 0.9 * 0.25)
        e = np.empty((5, 16), dtype=np.float64)
        e[0] = match.reshape(-1)
        e[1:] = 1.0 / 16.0
        return PairHmmModel(transitions=t, emissions=e)

    @staticmethod
    def random(rng: np.random.Generator) -> "PairHmmModel":
        """Random-start model for EM trials (randomStart=True, utils.py:512)."""
        t = rng.random((5, 5))
        # keep the sparsity structure of the trained models: short states
        # return only to match/self, long states to match/self.
        mask = np.array(
            [
                [1, 1, 1, 1, 1],
                [1, 1, 0, 0, 0],
                [1, 0, 1, 0, 0],
                [1, 0, 0, 1, 0],
                [1, 0, 0, 0, 1],
            ],
            dtype=np.float64,
        )
        t = t * mask
        t /= t.sum(axis=1, keepdims=True)
        e = rng.random((5, 16))
        e /= e.sum(axis=1, keepdims=True)
        return PairHmmModel(transitions=t, emissions=e)

    # ------------------------------------------------------------------ #
    # text format
    # ------------------------------------------------------------------ #
    @staticmethod
    def load(path: str) -> "PairHmmModel":
        with open(path) as fh:
            line1 = fh.readline().split()
            line2 = fh.readline().split()
        assert len(line1) == 1 + 25 + 1, (
            "expected 27 fields on hmm line 1, got %d" % len(line1)
        )
        assert len(line2) == 80, (
            "expected 80 fields on hmm line 2, got %d" % len(line2)
        )
        model_type = int(float(line1[0]))
        transitions = np.array(line1[1:26], dtype=np.float64).reshape(5, 5)
        likelihood = float(line1[26])
        emissions = np.array(line2, dtype=np.float64).reshape(5, 16)
        return PairHmmModel(
            transitions=transitions,
            emissions=emissions,
            likelihood=likelihood,
            model_type=model_type,
        )

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            fields = [str(self.model_type)]
            fields += [repr(float(x)) for x in self.transitions.reshape(-1)]
            fields.append(repr(float(self.likelihood)))
            fh.write(" ".join(fields) + " \n")
            fh.write(
                " ".join(repr(float(x)) for x in self.emissions.reshape(-1))
                + " \n"
            )

    # ------------------------------------------------------------------ #
    # XML flavour (hmm.txt.xml) — written after EM, read by the Hmm
    # analysis and HmmMetaAnalysis (reference analyses/hmm.py:15-47).
    # ------------------------------------------------------------------ #
    def write_xml(
        self,
        path: str,
        transitions_std: np.ndarray | None = None,
        emissions_std: np.ndarray | None = None,
    ) -> None:
        import xml.etree.ElementTree as ET

        t_std = (
            transitions_std
            if transitions_std is not None
            else np.zeros_like(self.transitions)
        )
        e_std = (
            emissions_std
            if emissions_std is not None
            else np.zeros_like(self.emissions)
        )
        root = ET.Element("hmms", {"likelihood": str(self.likelihood)})
        for i in range(NUM_STATES):
            for j in range(NUM_STATES):
                ET.SubElement(
                    root,
                    "transition",
                    {
                        "from": str(i),
                        "to": str(j),
                        "avg": str(self.transitions[i, j]),
                        "std": str(t_std[i, j]),
                    },
                )
        for state in range(NUM_STATES):
            for x in range(SYMBOL_NUMBER):
                for y in range(SYMBOL_NUMBER):
                    ET.SubElement(
                        root,
                        "emission",
                        {
                            "state": str(state),
                            "x": _BASES[x],
                            "y": _BASES[y],
                            "avg": str(
                                self.emissions[state, x * SYMBOL_NUMBER + y]
                            ),
                            "std": str(e_std[state, x * SYMBOL_NUMBER + y]),
                        },
                    )
        for trace in self.running_likelihoods:
            ET.SubElement(
                root,
                "hmm",
                {"runningLikelihoods": " ".join(str(v) for v in trace)},
            )
        from nanopore_tpu_torch.io.xmlio import pretty_xml

        with open(path, "w") as fh:
            fh.write(pretty_xml(root))

    # ------------------------------------------------------------------ #
    # post-processing math (utils.py:614-629)
    # ------------------------------------------------------------------ #
    def normalise_by_reference_gc_content(self, gc_content: float) -> None:
        """Renormalise non-insert-state emissions to a given GC background.

        Semantics of utils.py:normaliseHmmByReferenceGCContent:614-619: each
        ref-base row is normalised to sum to gc/2 (C,G rows) or (1-gc)/2
        (A,T rows).  Insert states {2,4} skipped (no ref base).
        """
        for state in range(NUM_STATES):
            if state in INSERT_STATES:
                continue
            m = self.emissions[state].reshape(4, 4)
            row_sums = m.sum(axis=1, keepdims=True)
            background = np.array(
                [
                    (1.0 - gc_content) / 2.0,
                    gc_content / 2.0,
                    gc_content / 2.0,
                    (1.0 - gc_content) / 2.0,
                ]
            ).reshape(4, 1)
            self.emissions[state] = (m / row_sums * background).reshape(-1)

    def modify_emissions_by_expected_variation_rate(
        self, substitution_rate: float
    ) -> None:
        """Fold an expected variant divergence into the match emissions.

        Semantics of utils.py:modifyHmmEmissionsByExpectedVariationRate:
        621-624: E' = E @ S with S = (1-r) on the diagonal and r/3 off it
        (mixing over the second/read-base axis).
        """
        r = substitution_rate
        s = np.full((4, 4), r / (SYMBOL_NUMBER - 1), dtype=np.float64)
        np.fill_diagonal(s, 1.0 - r)
        self.emissions[0] = (self.emissions[0].reshape(4, 4) @ s).reshape(-1)

    def set_indel_emissions_flat(self) -> None:
        """Flatten all gap-state emissions to 1/16.

        Semantics of utils.py:setHmmIndelEmissionsToBeFlat:626-629.
        """
        self.emissions[1:] = 1.0 / 16.0

    # ------------------------------------------------------------------ #
    # views for the kernel
    # ------------------------------------------------------------------ #
    def match_emissions(self) -> np.ndarray:
        """(4, 4) match emission matrix indexed [refBase, readBase]."""
        return self.emissions[0].reshape(4, 4)

    def gap_emissions(self) -> np.ndarray:
        """(5, 4) per-state marginal single-base emissions.

        Delete states marginalise over the read axis (they emit a ref
        base); insert states marginalise over the ref axis.  The match row
        is unused by the kernel (full 4x4 used instead).
        """
        out = np.zeros((NUM_STATES, 4), dtype=np.float64)
        for state in range(1, NUM_STATES):
            m = self.emissions[state].reshape(4, 4)
            if state in DELETE_STATES:
                out[state] = m.sum(axis=1)
            else:
                out[state] = m.sum(axis=0)
        return out

    def error_substitution_matrix(self) -> np.ndarray:
        """(4, 4) row-normalised match emissions.

        Semantics of marginAlignSnpCaller.loadHmmErrorSubstitutionMatrix
        (reference marginAlignSnpCaller.py:25-29).
        """
        m = self.emissions[0].reshape(4, 4).copy()
        return m / m.sum(axis=1, keepdims=True)


def model_from_numpy(transitions, emissions, likelihood: float = 0.0,
                     model_type: int = 1) -> PairHmmModel:
    """A model from plain (5, 5) and (5, 16) tables, copied as float64:
    how a model crosses between this package and the JAX package (whose
    ``PairHmmModel`` holds the same two numpy tables), in either
    direction."""
    t = np.array(transitions, np.float64)
    e = np.array(emissions, np.float64)
    if t.shape != (NUM_STATES, NUM_STATES) or e.shape != (NUM_STATES, 16):
        raise ValueError(
            "transitions must be (5, 5) and emissions (5, 16), got %s and %s"
            % (t.shape, e.shape)
        )
    return PairHmmModel(
        transitions=t, emissions=e, likelihood=float(likelihood),
        model_type=int(model_type),
    )
