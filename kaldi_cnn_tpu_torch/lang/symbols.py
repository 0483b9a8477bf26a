"""Symbol tables (ref: OpenFst SymbolTable as used by words.txt /
phones.txt in utils/prepare_lang.sh). id 0 is reserved for <eps>."""

from __future__ import annotations

from typing import Dict, Iterable, List


class SymbolTable:
    def __init__(self, symbols: Iterable[str] = ()):
        self._sym2id: Dict[str, int] = {"<eps>": 0}
        self._id2sym: List[str] = ["<eps>"]
        for s in symbols:
            self.add(s)

    def add(self, sym: str) -> int:
        if sym in self._sym2id:
            return self._sym2id[sym]
        i = len(self._id2sym)
        self._sym2id[sym] = i
        self._id2sym.append(sym)
        return i

    def id(self, sym: str) -> int:
        return self._sym2id[sym]

    def sym(self, i: int) -> str:
        return self._id2sym[i]

    def __contains__(self, sym: str) -> bool:
        return sym in self._sym2id

    def __len__(self) -> int:
        return len(self._id2sym)

    def ids(self, syms: Iterable[str]) -> List[int]:
        return [self.id(s) for s in syms]

    def syms(self, ids: Iterable[int]) -> List[str]:
        return [self.sym(i) for i in ids]

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            for i, s in enumerate(self._id2sym):
                f.write(f"{s} {i}\n")

    @staticmethod
    def read(path: str) -> "SymbolTable":
        t = SymbolTable()
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                sym, i = parts[0], int(parts[1])
                if sym == "<eps>":
                    continue
                assert t.add(sym) == i, f"non-contiguous symbol table {path}"
        return t
