"""Anatomical relabeling of airway branches ("regrade").

Re-implements the reference's per-junction direction-cosine matching
that renames hierarchical branch codes into the ~15 named bronchial
segments (reference ours_skel_parse.py:653-978). The machinery:

  * at a named junction, take the children (by father code), compute
    the cosine of each child's chord (end-start) against per-segment
    anatomical direction templates (z-signs depend on the volume
    orientation `order`), and greedily assign the anatomical codes by
    best similarity (`_update_segment_codes` semantics);
  * descendants' codes are prefix-rewritten with the new names;
  * weak matches set "missing branch" flags (rb123/rb45/rb6/lb123/
    l010) and push the whole subtree one generation down (insert '1');
  * the right main bronchus has a >2-children special case.

Faithfulness notes: the reference initializes flags rb23/rb12 but
never sets them, so the CLI's conditional remerge never fires — we
keep the same flags for API parity. Its multi-branch path calls an
UNDEFINED `_exchange_grade` (would raise AttributeError); here that
step swaps the two top-level codes, which is the evident intent.

Anatomical code map (right lung: 000* upper, 001* middle/lower;
left: 010* upper, 011* lower), matching the reference's comments.

Host code, a copy of the JAX package's `post/regrade.py`.
"""

from __future__ import annotations

import numpy as np

from .topology import Branch, _cosine


def _v(order: int, x, y, z):
    """Direction template; z flips with volume orientation."""
    return np.array([x, y, -z if order == 1 else z], np.float64)


class AnatomicalRegrader:
    def __init__(self, branches: list[Branch], codes: list[dict], order: int):
        self.br = branches
        self.g = codes  # [{'code', 'father_code'}] parallel to branches
        self.order = order
        self.flags = dict(rb23=0, rb12=0, rb45=0, rb6=0, lb123=0, l010=0,
                          rb123=0)

    # ---- generic helpers -------------------------------------------------

    def _children(self, start: str) -> list[int]:
        idxs = [i for i, c in enumerate(self.g) if c["father_code"] == start]
        return sorted(idxs, key=lambda i: self.g[i]["code"])

    def _chord(self, i: int) -> np.ndarray:
        b = self.br[i]
        end = b.end if b.end is not None else (b.member[-1] if b.member else b.start)
        return np.asarray(end, np.float64) - np.asarray(b.start, np.float64)

    def _sims(self, idxs: list[int], vectors) -> np.ndarray:
        """(n_vectors, n_children) cosine matrix."""
        return np.array(
            [[_cosine(self._chord(i), v) for i in idxs] for v in vectors]
        )

    def _rename_subtree(self, old: str, new: str, viewed: set[int]):
        for j, c in enumerate(self.g):
            if c["code"].startswith(old) and c["code"] != old and j not in viewed:
                viewed.add(j)
                c["code"] = new + c["code"][len(old):]
                c["father_code"] = new + c["father_code"][len(old):]
            elif c["code"] == old and j not in viewed:
                c["code"] = new
                viewed.add(j)

    def _assign(self, idxs: list[int], values: np.ndarray, haoma: list[str]):
        """Greedy best-similarity code assignment + subtree renames
        (reference _update_segment_codes, ours_skel_parse.py:939-978)."""
        n = len(idxs)
        new_codes: list[str | None] = [None] * n
        assigned = [False] * len(haoma)
        used = set()
        remaining = list(range(n))
        while remaining:
            remaining.sort(key=lambda k: -values[:, k].max())
            cur = remaining.pop(0)
            for vi in np.argsort(-values[:, cur]):
                if not assigned[vi] or len(remaining) == len(haoma) - len(used):
                    new_codes[cur] = haoma[vi]
                    assigned[vi] = True
                    used.add(haoma[vi])
                    break
        viewed: set[int] = set()
        for k, i in enumerate(idxs):
            old = self.g[i]["code"]
            new = new_codes[k]
            if new is None or new == old:
                continue
            self._rename_subtree(old, new, viewed)

    def _push_down(self, start: str):
        """Insert '1' after `start` in every descendant (missing-branch
        handling, reference ours_skel_parse.py:933-937)."""
        for c in self.g:
            if c["code"].startswith(start) and c["code"] != start:
                c["code"] = start + "1" + c["code"][len(start):]
                c["father_code"] = start + "1" + c["father_code"][len(start):]

    def _junction(self, start: str, vectors, handler):
        idxs = self._children(start)
        if len(idxs) > 1:
            handler(start, vectors, idxs)

    # ---- junction handlers ----------------------------------------------

    def _simple(self, haoma, three=None):
        """Handler factory: 2-child greedy assign; optional 3-child
        variant (vectors3(order), haoma3); optional missing-branch test
        (threshold, flag) applied on the first template row."""

        def handle(start, vectors, idxs, *, missing=None, nested=None):
            vals = self._sims(idxs, vectors)
            if vals.shape[1] == 2:
                if missing is not None:
                    thr, flag = missing
                    if vals[0].max() <= thr:
                        self.flags[flag] = 1
                        self._push_down(start)
                self._assign(idxs, vals, list(haoma))
                if nested is not None:
                    nested()
            elif vals.shape[1] == 3 and three is not None:
                vecs3, haoma3 = three
                vals3 = self._sims(idxs, vecs3(self.order))
                self._assign(idxs, vals3, list(haoma3))

        return handle

    def _right_main(self, start, vectors, idxs):
        """'00' junction: >2-children special case + rb123 missing
        (reference _right, ours_skel_parse.py:811-820)."""
        vals = self._sims(idxs, vectors)
        haoma = ["000", "001"]
        if vals.shape[1] > 2 and (vals.max(axis=0) <= 0.85).sum() == 1:
            self._multi_branch(haoma, idxs, vals, start, vectors)
        elif vals[0].max() <= 0.85:
            self.flags["rb123"] = 1
            self._push_down(start)
        elif vals.shape[1] == 2:
            self._assign(idxs, vals, haoma)

    def _multi_branch(self, haoma, idxs, vals, start, vectors):
        """>2 children with one outlier (reference
        _handle_multiple_branches, ours_skel_parse.py:908-931)."""
        wrong = set(np.where(vals.max(axis=0) <= 0.75)[0].tolist())
        viewed: set[int] = set()
        pool = list(haoma)
        for k, i in enumerate(idxs):
            if k in wrong or not pool:
                continue
            new = pool.pop(0)
            if new == self.g[i]["code"]:
                continue
            self._rename_subtree(self.g[i]["code"], new, viewed)
        idxs2 = self._children(start)
        vals2 = self._sims(idxs2, vectors)
        vals2 = np.delete(vals2, list(wrong), axis=1) if wrong else vals2
        if vals2.shape[1] >= 2 and np.argmax(vals2[0]) != 0 and np.argmax(vals2[1]) != 1:
            # the reference calls an undefined _exchange_grade here; the
            # evident intent is swapping the two anatomical subtrees
            a, b = self.g[idxs2[0]]["code"], self.g[idxs2[1]]["code"]
            viewed = set()
            self._rename_subtree(a, "\x00tmp", viewed)
            viewed = set()
            self._rename_subtree(b, a, viewed)
            viewed = set()
            self._rename_subtree("\x00tmp", b, viewed)

    # ---- the rule program (reference regrade, ours_skel_parse.py:653-720)

    def run(self):
        o = self.order
        J = self._junction

        J("0", [_v(o, 0, -1, 0), _v(o, 0, 1, 0)],
          lambda s, v, i: self._assign(i, self._sims(i, v), ["00", "01"])
          if len(i) == 2 else None)

        J("00", [np.array([0, -1, 0.1]), _v(o, 0, -1, 1)], self._right_main)

        J("000", [_v(o, 0, 0, -1), np.array([-1, -1, 0]), np.array([1, 0, 0])],
          lambda s, v, i: self._assign(i, self._sims(i, v), ["0000", "0001", "0002"])
          if len(i) == 3 else None)

        def right_middle(start, vectors, idxs):
            self._simple(
                ["0010", "0011"],
                three=(lambda o: [np.array([1, -0.7, 0]), np.array([-1, 0, 0]),
                                  _v(o, 0, -0.4, 1)],
                       ["0010", "00110", "00111"]),
            )(start, vectors, idxs,
              missing=(0.5, "rb45"),
              nested=lambda: J(
                  "0011", [np.array([-1, -0.1, 0]), _v(o, 0, 0, 1)],
                  lambda s, v, i: self._simple(["00110", "00111"])(
                      s, v, i, missing=(0.5, "rb6"))))

        J("001", [_v(o, 1, -1, 0.25), _v(o, 0, 0, 1)], right_middle)

        J("0010", [np.array([0, -1, 0]), np.array([1, 0, 0])],
          self._simple(["00100", "00101"]))

        J("00111", [np.array([0, 1, 0]), np.array([0, -1, 0])],
          self._simple(["001110", "001111"],
                       three=(lambda o: [np.array([0, -1, 0]), _v(o, 0, -0.1, 1),
                                         _v(o, 0, 0.3, 1)],
                              ["0011110", "0011111", "001110"])))

        J("001111", [np.array([0, -1, 0]), np.array([0, 1, 0])],
          self._simple(["0011110", "0011111"],
                       three=(lambda o: [np.array([0, -1, 0]), _v(o, 0, -0.4, 1),
                                         _v(o, 0, 0.2, 1)],
                              ["0011110", "00111110", "00111111"])))

        J("0011111", [np.array([0, -1, 0]), np.array([0, 1, 0])],
          self._simple(["00111110", "00111111"]))

        def left(start, vectors, idxs):
            vals = self._sims(idxs, vectors)
            if vals[0].max() <= 0.7 or vals[:, 0].max() <= 0.7:
                self.flags["l010"] = 1
                self._push_down(start)
            if vals.shape[1] == 2:
                self._assign(idxs, vals, ["010", "011"])

        J("01", [np.array([0, 1, 0]), _v(o, 0, 0.18, 1)], left)

        def left_upper(start, vectors, idxs):
            vals = self._sims(idxs, vectors)
            if vals.shape[1] == 2:
                if vals[0].max() <= 0.4:
                    self.flags["lb123"] = 1
                    self._push_down(start)
                self._assign(idxs, vals, ["0100", "0101"])
                J("0100", [_v(o, -1, 0, -1), np.array([1, 0, 0])],
                  self._simple(["01000", "01001"],
                               three=(lambda o: [_v(o, -1, 0, -1),
                                                 _v(o, 0, 1, 0.1),
                                                 np.array([1, 0, 0])],
                                      ["01000", "01001", "01002"])))
            elif vals.shape[1] == 3:
                vecs3 = [_v(o, -1, 0, -1), np.array([1, 0, 0]), _v(o, 0, 0, 1)]
                self._assign(idxs, self._sims(idxs, vecs3),
                             ["01000", "01001", "0101"])

        J("010", [_v(o, 0, 0, -1), _v(o, 0, 0, 1)], left_upper)

        J("0101", [np.array([0, 1, 0]), _v(o, 1, 0, 1)],
          self._simple(["01010", "01011"]))

        J("011", [np.array([-1, 0, 0]), _v(o, 0, 0, 1)],
          self._simple(["0110", "0111"]))

        J("0111", [np.array([1, 1, 0]), _v(o, 0, 0, 1)],
          self._simple(["01110", "01111"],
                       three=(lambda o: [np.array([1, 1, 0]), _v(o, 0, 0.3, 1),
                                         _v(o, 0, -0.3, 1)],
                              ["01110", "011110", "011111"])))

        J("01111", [np.array([0, 1, 0]), np.array([0, -1, 0])],
          self._simple(["011110", "011111"]))

        return self.g, self.flags
