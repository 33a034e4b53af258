"""Indexed FASTA reader (replaces the reference's `samtools faidx`
subprocesses, e.g. reference dataPrepScripts/CreateTensor.py:136).

Supports .fai index files (building one if absent) and 0-based half-open
fetches returned uppercased, matching the reference's behaviour of
uppercasing masked sequence.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple


class FaiEntry:
    __slots__ = ("name", "length", "offset", "line_bases", "line_bytes")

    def __init__(self, name: str, length: int, offset: int, line_bases: int, line_bytes: int):
        self.name = name
        self.length = length
        self.offset = offset
        self.line_bases = line_bases
        self.line_bytes = line_bytes


def build_fai(fasta_path: str, fai_path: Optional[str] = None) -> str:
    """Write a samtools-compatible .fai index."""
    fai_path = fai_path or fasta_path + ".fai"
    entries: List[FaiEntry] = []
    with open(fasta_path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        line_bases = line_bytes = 0
        pos = 0
        for raw in fh:
            line_len = len(raw)
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    entries.append(FaiEntry(name, length, offset, line_bases, line_bytes))
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + line_len
                line_bases = line_bytes = 0
            elif line:
                if line_bases == 0:
                    line_bases, line_bytes = len(line), line_len
                length += len(line)
            pos += line_len
        if name is not None:
            entries.append(FaiEntry(name, length, offset, line_bases, line_bytes))
    with open(fai_path, "w") as out:
        for entry in entries:
            out.write(
                f"{entry.name}\t{entry.length}\t{entry.offset}"
                f"\t{entry.line_bases}\t{entry.line_bytes}\n"
            )
    return fai_path


class FastaReader:
    def __init__(self, fasta_path: str):
        self.path = fasta_path
        fai_path = fasta_path + ".fai"
        if not os.path.isfile(fai_path):
            build_fai(fasta_path, fai_path)
        self._entries: Dict[str, FaiEntry] = {}
        self._order: List[str] = []
        with open(fai_path) as fh:
            for row in fh:
                columns = row.split("\t")
                entry = FaiEntry(
                    columns[0], int(columns[1]), int(columns[2]),
                    int(columns[3]), int(columns[4]),
                )
                self._entries[entry.name] = entry
                self._order.append(entry.name)
        self._fh = open(fasta_path, "rb")

    @property
    def contigs(self) -> List[Tuple[str, int]]:
        return [(n, self._entries[n].length) for n in self._order]

    def contig_length(self, name: str) -> int:
        return self._entries[name].length

    def fetch(self, contig: str, start: int = 0, end: Optional[int] = None) -> str:
        """0-based half-open fetch, clamped to contig bounds, uppercased."""
        entry = self._entries[contig]
        start = max(0, start)
        end = entry.length if end is None else min(end, entry.length)
        if start >= end:
            return ""
        first_byte = entry.offset + (start // entry.line_bases) * entry.line_bytes + (
            start % entry.line_bases
        )
        last_byte = entry.offset + ((end - 1) // entry.line_bases) * entry.line_bytes + (
            (end - 1) % entry.line_bases
        )
        self._fh.seek(first_byte)
        raw = self._fh.read(last_byte - first_byte + 1)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode("ascii").upper()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
