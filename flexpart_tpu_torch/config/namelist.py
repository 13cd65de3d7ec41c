"""Fortran-namelist parsing.

The reference drives everything from Fortran namelist files in ``options/``
(COMMAND, RELEASES, OUTGRID, AGECLASSES, RECEPTORS, SPECIES_nnn; see
readcommand.f90:69-101 and friends).  We parse the same
on-disk format into plain Python dicts so reference run directories work as
drop-in inputs, but the in-memory representation is our own typed config.
"""

from __future__ import annotations

import re
from typing import Any


_GROUP_RE = re.compile(r"&(\w+)", re.IGNORECASE)


def _strip_comment(line: str) -> str:
    """Remove trailing '!' comments, respecting quoted strings."""
    out = []
    in_quote: str | None = None
    for ch in line:
        if in_quote:
            out.append(ch)
            if ch == in_quote:
                in_quote = None
        elif ch in "\"'":
            in_quote = ch
            out.append(ch)
        elif ch == "!":
            break
        else:
            out.append(ch)
    return "".join(out)


def _parse_value(tok: str) -> Any:
    tok = tok.strip()
    if not tok:
        return None
    if tok[0] in "\"'":
        return tok.strip(tok[0])
    low = tok.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        # Fortran double-precision exponent markers
        return float(tok.replace("d", "e").replace("D", "E"))
    except ValueError:
        return tok


def _split_values(text: str) -> list[str]:
    """Split a namelist RHS on commas, respecting quotes."""
    vals, cur, in_quote = [], [], None
    for ch in text:
        if in_quote:
            cur.append(ch)
            if ch == in_quote:
                in_quote = None
        elif ch in "\"'":
            in_quote = ch
            cur.append(ch)
        elif ch == ",":
            vals.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    vals.append("".join(cur))
    return [v.strip() for v in vals]


def parse_namelist(text: str) -> list[tuple[str, dict[str, Any]]]:
    """Parse namelist text into an ordered list of (group_name, {key: value}).

    Repeated groups (e.g. multiple ``&RELEASE`` blocks,
    options/RELEASES:15-30) are preserved in order.  Values
    that are comma-separated lists (e.g. OUTHEIGHTS) become Python lists.
    """
    groups: list[tuple[str, dict[str, Any]]] = []
    cur_name: str | None = None
    cur: dict[str, Any] = {}
    # Accumulate logical "statements" (key = values possibly spanning lines).
    pending = ""

    def flush_pending() -> None:
        nonlocal pending
        stmt = pending.strip().rstrip(",").strip()
        pending = ""
        if not stmt or "=" not in stmt:
            return
        # a statement may hold SEVERAL assignments ("A=1, B=2, C=3,"
        # on one line is legal namelist syntax); find assignment starts
        # outside quoted strings and split there
        starts: list[tuple[int, int, str]] = []
        for m in re.finditer(r"[A-Za-z_]\w*\s*=", stmt):
            i = m.start()
            q = None
            for ch in stmt[:i]:
                if q:
                    if ch == q:
                        q = None
                elif ch in "\"'":
                    q = ch
            if q is not None:
                continue
            if i == 0 or stmt[i - 1] in " ,\t":
                key = stmt[i:m.end() - 1].strip().rstrip("=").strip()
                starts.append((i, m.end(), key))
        for idx, (_, vstart, key) in enumerate(starts):
            vend = starts[idx + 1][0] if idx + 1 < len(starts) else len(stmt)
            rhs = stmt[vstart:vend].strip().rstrip(",")
            vals = [_parse_value(v) for v in _split_values(rhs)
                    if v.strip()]
            if vals:
                cur[key.lower()] = vals[0] if len(vals) == 1 else vals

    for raw in text.splitlines():
        line = _strip_comment(raw).strip()
        if not line:
            continue
        if cur_name is None:
            m = _GROUP_RE.match(line)
            if m:
                cur_name = m.group(1).lower()
                line = line[m.end():].strip()
            else:
                continue  # banner text outside groups
        # inside a group
        while line:
            if line.startswith("/"):
                flush_pending()
                groups.append((cur_name, cur))
                cur_name, cur = None, {}
                line = line[1:].strip()
                m = _GROUP_RE.match(line)
                if m:
                    cur_name = m.group(1).lower()
                    line = line[m.end():].strip()
                else:
                    break
                continue
            # a new `key =` starts a new statement
            if re.match(r"^\s*\w+\s*=", line) and pending.strip().rstrip(",") != "":
                flush_pending()
            # a group terminator may share the line with assignments
            # ("A=1, B=2 /"): split at the first unquoted '/'
            slash = -1
            q = None
            for i, ch in enumerate(line):
                if q:
                    if ch == q:
                        q = None
                elif ch in "\"'":
                    q = ch
                elif ch == "/":
                    slash = i
                    break
            if slash >= 0:
                pending += " " + line[:slash]
                line = line[slash:]
            else:
                pending += " " + line
                line = ""
    if cur_name is not None:  # unterminated group
        flush_pending()
        groups.append((cur_name, cur))
    return groups


def namelist_groups(text: str, name: str) -> list[dict[str, Any]]:
    return [g for n, g in parse_namelist(text) if n == name.lower()]


def namelist_single(text: str, name: str) -> dict[str, Any]:
    gs = namelist_groups(text, name)
    if len(gs) != 1:
        raise ValueError(f"expected exactly one &{name} group, found {len(gs)}")
    return gs[0]
