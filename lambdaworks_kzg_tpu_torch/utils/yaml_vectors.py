"""Reader for the consensus-spec vectors' `data.yaml` files, with no YAML
library.

The six functions' files are a block mapping (`input:`, `output:`) whose
values are flow collections of single-quoted hex strings, `null`, `true`
and `false`, where a flow value may run on over more indented lines, and
`input:` may instead open an indented block mapping of such values (the
batch files). `parse_vector` reads exactly that and gives what
`yaml.safe_load` gives; anything else raises ValueError. `load_case`
also turns every '0x...' string into bytes.
"""

import re

_KEY = re.compile(r"^( *)([A-Za-z_][A-Za-z0-9_]*):(?: +(.*))?$")
_TOKEN = re.compile(r"\s*(?:([{}\[\],:])|'([^']*(?:''[^']*)*)'|([A-Za-z_][A-Za-z0-9_]*))")
_WORDS = {"null": None, "true": True, "false": False}


def _indent(line: str) -> int:
    return len(line) - len(line.lstrip(" "))


def _tokens(text: str):
    out, pos = [], 0
    text = text.rstrip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"unrecognised flow value near {text[pos:pos + 20]!r}")
        punct, quoted, word = m.groups()
        if punct is not None:
            out.append(("p", punct))
        elif quoted is not None:
            out.append(("s", quoted.replace("''", "'")))
        else:
            out.append(("w", word))
        pos = m.end()
    return out + [("end", "")]


def _flow(tokens, i: int):
    """One flow value at tokens[i] -> (value, next index)."""
    kind, tok = tokens[i]
    if kind == "end":
        raise ValueError("flow value ends early")
    if kind == "s":
        return tok, i + 1
    if kind == "w":
        if tok not in _WORDS:
            raise ValueError(f"unsupported plain scalar {tok!r}")
        return _WORDS[tok], i + 1
    if tok not in "{[":
        raise ValueError(f"unexpected {tok!r}")
    close, i = "}" if tok == "{" else "]", i + 1
    out = {} if tok == "{" else []
    while True:
        if tokens[i:i + 1] == [("p", close)] and not out:
            return out, i + 1
        if close == "}":
            kind, key = tokens[i]
            if kind in ("p", "end") or tokens[i + 1:i + 2] != [("p", ":")] or key in out:
                raise ValueError("bad flow mapping key")
            out[key], i = _flow(tokens, i + 2)
        else:
            value, i = _flow(tokens, i)
            out.append(value)
        if tokens[i:i + 1] == [("p", close)]:
            return out, i + 1
        if tokens[i:i + 1] != [("p", ",")]:
            raise ValueError("expected ',' or a closing bracket")
        i += 1


def _block(lines, i: int, indent: int):
    """The block mapping at lines[i] indented by `indent` -> (dict, next)."""
    out = {}
    while i < len(lines):
        m = _KEY.match(lines[i])
        if m is None:
            raise ValueError(f"unrecognised line: {lines[i][:40]!r}")
        if len(m.group(1)) < indent:
            break
        key, rest = m.group(2), m.group(3)
        if len(m.group(1)) > indent or key in out:
            raise ValueError(f"bad indentation or repeated key at {key!r}")
        i += 1
        if not rest:
            if i == len(lines) or _indent(lines[i]) <= indent:
                raise ValueError(f"{key!r} has no value")
            out[key], i = _block(lines, i, _indent(lines[i]))
            continue
        parts = [rest]
        while i < len(lines) and _indent(lines[i]) > indent:
            parts.append(lines[i].strip())
            i += 1
        tokens = _tokens(" ".join(parts))
        out[key], end = _flow(tokens, 0)
        if tokens[end][0] != "end":
            raise ValueError(f"trailing text after the value of {key!r}")
    return out, i


def parse_vector(text: str) -> dict:
    """A data.yaml text -> the same dict `yaml.safe_load` gives."""
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    out, i = _block(lines, 0, 0)
    if i != len(lines) or set(out) != {"input", "output"}:
        raise ValueError("a vector is a mapping of input and output")
    return out


def _hex_to_bytes(value):
    if isinstance(value, str):
        if not value.startswith("0x"):
            raise ValueError(f"not a hex string: {value[:20]!r}")
        return bytes.fromhex(value[2:])
    if isinstance(value, list):
        return [_hex_to_bytes(v) for v in value]
    if isinstance(value, dict):
        return {k: _hex_to_bytes(v) for k, v in value.items()}
    return value


def load_case(path: str) -> dict:
    """A data.yaml file -> {"input": {...}, "output": ...} with every hex
    string as bytes."""
    with open(path, "r", encoding="utf-8") as f:
        return _hex_to_bytes(parse_vector(f.read()))


def load_commitment_vector(path: str):
    """A blob_to_kzg_commitment file -> (blob bytes, commitment bytes or None)."""
    case = load_case(path)
    if set(case["input"]) != {"blob"}:
        raise ValueError("not a blob_to_kzg_commitment vector")
    return case["input"]["blob"], case["output"]
