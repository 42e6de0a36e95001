"""Reader for the consensus-spec `blob_to_kzg_commitment` data.yaml files.

Those files hold exactly two lines, `input: {blob: '0x...'}` and
`output: '0x...'` (or `output: null`), so a full YAML parser is not
needed; anything else raises ValueError.
"""

import re

_INPUT = re.compile(r"^input:\s*\{\s*blob:\s*'0x([0-9a-fA-F]*)'\s*\}\s*$")
_OUTPUT = re.compile(r"^output:\s*(?:'0x([0-9a-fA-F]*)'|(null))\s*$")


def parse_commitment_vector(text: str):
    """-> (blob bytes, commitment bytes or None)."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if len(lines) != 2:
        raise ValueError("expected two lines: input and output")
    m_in = _INPUT.match(lines[0].strip())
    m_out = _OUTPUT.match(lines[1].strip())
    if m_in is None or m_out is None:
        raise ValueError("unrecognised blob_to_kzg_commitment vector")
    blob = bytes.fromhex(m_in.group(1))
    out = None if m_out.group(2) else bytes.fromhex(m_out.group(1))
    return blob, out


def load_commitment_vector(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return parse_commitment_vector(f.read())
