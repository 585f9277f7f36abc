"""Compiler argv parsing and rewriting (a copy of the JAX package's
yadcc_tpu/client/compiler_args.py).

Parity with reference yadcc/client/cxx/compiler_args.h:30-86 and
common/rewritten_args: understand just enough GCC-style argv to (a) tell
whether an invocation is distributable, (b) find the sources and -o, and
(c) produce rewritten argument vectors for preprocessing and for remote
execution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

# Options that consume the NEXT argv element.
_OPTIONS_WITH_VALUE = {
    "-o", "-x", "-include", "-imacros", "-isystem", "-iquote", "-idirafter",
    "-iprefix", "-iwithprefix", "-iwithprefixbefore", "-isysroot", "-I",
    "-L", "-D", "-U", "-MF", "-MT", "-MQ", "-arch", "-Xpreprocessor",
    "-Xassembler", "-Xlinker", "-Xclang", "-T", "-u", "-z", "-G",
    "--param", "-aux-info", "-A", "-l", "-e",
}

_SOURCE_SUFFIXES = (".c", ".cc", ".cp", ".cxx", ".cpp", ".c++", ".C",
                    ".i", ".ii")
_ASM_SUFFIXES = (".s", ".S", ".sx")


@dataclass
class CompilerArgs:
    compiler: str                      # argv[0] as invoked
    args: List[str]                    # everything after argv[0]
    sources: List[str] = field(default_factory=list)
    _parsed: List[Tuple[str, Optional[str]]] = field(default_factory=list)

    @classmethod
    def parse(cls, argv: Sequence[str]) -> "CompilerArgs":
        self = cls(compiler=argv[0], args=list(argv[1:]))
        i = 0
        while i < len(self.args):
            a = self.args[i]
            if a in _OPTIONS_WITH_VALUE and i + 1 < len(self.args):
                self._parsed.append((a, self.args[i + 1]))
                i += 2
                continue
            if a.startswith("-"):
                self._parsed.append((a, None))
                i += 1
                continue
            self.sources.append(a)
            self._parsed.append((a, None))
            i += 1
        return self

    # -- queries -------------------------------------------------------------

    def try_get(self, option: str) -> Optional[str]:
        """Value of a value-taking option (last wins), or None."""
        out = None
        for opt, val in self._parsed:
            if opt == option and val is not None:
                out = val
            elif opt.startswith(option) and len(opt) > len(option) \
                    and option in _OPTIONS_WITH_VALUE:
                out = opt[len(option):]  # joined form, e.g. -o/tmp/x.o
        return out

    def has(self, option: str) -> bool:
        return any(opt == option for opt, _ in self._parsed)

    def has_prefix(self, prefix: str) -> bool:
        return any(opt.startswith(prefix) for opt, _ in self._parsed)

    def output_file(self) -> Optional[str]:
        out = self.try_get("-o")
        if out:
            return out
        if self.has("-c") and len(self.sources) == 1:
            src = self.sources[0]
            base = src.rsplit("/", 1)[-1]
            stem = base.rsplit(".", 1)[0]
            return stem + ".o"
        return None

    # -- rewriting -----------------------------------------------------------

    def rewrite(
        self,
        *,
        remove: Sequence[str] = (),
        remove_prefix: Sequence[str] = (),
        add: Sequence[str] = (),
        keep_sources: bool = True,
    ) -> List[str]:
        """New argv tail (no compiler name).  `remove` drops exact options
        (and their values); `remove_prefix` drops any option starting
        with a prefix (its value too, for value-taking exact matches)."""
        out: List[str] = []
        skip_next = False
        for i, a in enumerate(self.args):
            if skip_next:
                skip_next = False
                continue
            is_source = not a.startswith("-") and a in self.sources
            if is_source:
                if keep_sources:
                    out.append(a)
                continue
            takes_value = a in _OPTIONS_WITH_VALUE and i + 1 < len(self.args)
            if a in remove or any(a.startswith(p) for p in remove_prefix):
                skip_next = takes_value
                continue
            out.append(a)
            if takes_value:
                out.append(self.args[i + 1])
                skip_next = True
        out.extend(add)
        return out


def is_distributable(args: CompilerArgs) -> Tuple[bool, str]:
    """Reference yadcc-cxx.cc:37-65: only plain single-file C/C++
    compiles (-c) go to the cloud; everything else (linking, multi-file,
    assembly, stdin, preprocessing-only) runs locally."""
    if not args.has("-c"):
        return False, "not a compile-only invocation (-c missing)"
    if len(args.sources) != 1:
        return False, f"{len(args.sources)} input files"
    src = args.sources[0]
    if src == "-":
        return False, "reads stdin"
    if src.endswith(_ASM_SUFFIXES):
        return False, "assembly input"
    if not src.endswith(_SOURCE_SUFFIXES):
        return False, f"unrecognized source suffix: {src}"
    if args.has("-E") or args.has("-S"):
        return False, "preprocess/assembly output requested"
    for bad in ("-march=native", "-mtune=native"):
        if args.has(bad):
            return False, f"{bad} is machine-dependent"
    if args.has_prefix("-fplugin") or args.has_prefix("-specs"):
        return False, "compiler plugins/specs are local-only"
    return True, ""
