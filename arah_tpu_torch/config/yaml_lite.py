"""A reader for the subset of YAML that the configs under `configs/` use,
typed as `yaml.safe_load` types it. The port reads its configs with it,
so that it needs no YAML package.

Accepted forms:
  - block mappings and block lists (a list may sit at its key's indent);
  - flow mappings and lists (`{a: 1, b: [x, y]}`), also over several lines;
  - anchors (`&id001`) on a value and aliases (`*id001`), an alias being
    the anchored object itself, as PyYAML gives it;
  - single- and double-quoted strings (the double-quoted with the simple
    backslash escapes) and plain strings;
  - decimal ints, floats with a dot (`1.0e-5`, `1.0e+1`, `.5`), `.inf`,
    `.nan`, `true`/`false` and `null`/`~`, as YAML 1.1 resolves them;
  - `#` comments.

Anything else (tags, block scalars, several documents, tabs in the
indentation, a key in a list item, `yes`/`no`/`on`/`off`, octal, hex or
underscored numbers, a float without a dot, ...) raises `YamlError` with
the file and line: the reader does not guess."""
from __future__ import annotations

import re

_INT = re.compile(r'[-+]?(?:0|[1-9][0-9]*)$')
_FLOAT = re.compile(r'[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$')
# forms that YAML 1.1 resolves to something this reader does not take
_REFUSED = re.compile(
    r'(?:[-+]?0b[01_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+'
    r'|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?'
    r'|[-+]?[0-9][0-9_]*\.?[0-9_]*(?:[eE][-+]?[0-9]+)?'
    r'|yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|=|<<)$')
_NULL = ('null', 'Null', 'NULL', '~', '')
_TRUE = ('true', 'True', 'TRUE')
_FALSE = ('false', 'False', 'FALSE')
_ESCAPES = {'n': '\n', 't': '\t', '\\': '\\', '"': '"', '/': '/', '0': '\0',
            'r': '\r'}


class YamlError(ValueError):
    pass


class _Line:
    __slots__ = ('no', 'indent', 'text')

    def __init__(self, no, indent, text):
        self.no, self.indent, self.text = no, indent, text


def _strip_comment(s: str) -> str:
    """s without a trailing `#` comment (one at the start or after a
    space, outside quotes)."""
    quote = None
    for i, c in enumerate(s):
        if quote:
            if c == quote:
                quote = None
        elif c in '\'"' and (i == 0 or s[i - 1] in ' ,[{:-'):
            quote = c
        elif c == '#' and (i == 0 or s[i - 1] in ' \t'):
            return s[:i]
    return s


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.anchors = {}
        self.lines = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(' ')
            if stripped.startswith('\t') or '\t' in body[:len(body)
                                                         - len(stripped)]:
                self.fail(no, 'a tab in the indentation')
            if stripped in ('---', '...') or stripped.startswith(
                    ('--- ', '%')):
                self.fail(no, 'document markers and directives')
            self.lines.append(_Line(no, len(body) - len(stripped), stripped))
        self.pos = 0

    def fail(self, no, what):
        raise YamlError(f'{self.name}:{no}: unsupported YAML: {what}')

    # ------------------------------------------------------------ scalars
    def scalar(self, s: str, no: int):
        if s.startswith("'"):
            if len(s) < 2 or not s.endswith("'"):
                self.fail(no, f'unterminated quote {s!r}')
            inner = s[1:-1]
            if re.search(r"(?<!')'(?!')", inner.replace("''", '')):
                self.fail(no, f'quote inside {s!r}')
            return inner.replace("''", "'")
        if s.startswith('"'):
            if len(s) < 2 or not s.endswith('"'):
                self.fail(no, f'unterminated quote {s!r}')
            out, i, inner = [], 0, s[1:-1]
            while i < len(inner):
                c = inner[i]
                if c == '\\':
                    if i + 1 >= len(inner) or inner[i + 1] not in _ESCAPES:
                        self.fail(no, f'escape in {s!r}')
                    out.append(_ESCAPES[inner[i + 1]])
                    i += 2
                    continue
                if c == '"':
                    self.fail(no, f'quote inside {s!r}')
                out.append(c)
                i += 1
            return ''.join(out)
        if s in _NULL:
            return None
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        if _INT.match(s):
            return int(s)
        if _FLOAT.match(s):
            return float(s)
        low = s.lower()
        if low in ('.inf', '+.inf'):
            return float('inf')
        if low == '-.inf':
            return float('-inf')
        if low == '.nan':
            return float('nan')
        if _REFUSED.match(s):
            self.fail(no, f'the scalar {s!r} (YAML 1.1 types it; write it '
                      'quoted or in a plain decimal form)')
        if s[0] in '&*!|>%@`{}[],?:#' or s.startswith('- ') or ': ' in s \
                or s.endswith(':') or ' #' in s:
            self.fail(no, f'the scalar {s!r}')
        return s

    # --------------------------------------------------------------- flow
    def flow(self, s: str, no: int):
        value, rest = self._flow_value(s.strip(), no)
        if rest.strip():
            self.fail(no, f'text after a flow collection: {rest!r}')
        return value

    def _flow_value(self, s: str, no: int):
        s = s.lstrip()
        if s.startswith('['):
            out, s = [], s[1:].lstrip()
            if s.startswith(']'):
                return out, s[1:]
            while True:
                v, s = self._flow_value(s, no)
                out.append(v)
                s = s.lstrip()
                if s.startswith(','):
                    s = s[1:].lstrip()
                    if s.startswith(']'):
                        return out, s[1:]
                    continue
                if s.startswith(']'):
                    return out, s[1:]
                self.fail(no, f'flow list near {s!r}')
        if s.startswith('{'):
            out, s = {}, s[1:].lstrip()
            if s.startswith('}'):
                return out, s[1:]
            while True:
                k, s = self._flow_scalar(s, no, key=True)
                s = s.lstrip()
                if not s.startswith(':'):
                    self.fail(no, f'flow mapping near {s!r}')
                v, s = self._flow_value(s[1:], no)
                out[k] = v
                s = s.lstrip()
                if s.startswith(','):
                    s = s[1:].lstrip()
                    if s.startswith('}'):
                        return out, s[1:]
                    continue
                if s.startswith('}'):
                    return out, s[1:]
                self.fail(no, f'flow mapping near {s!r}')
        return self._flow_scalar(s, no)

    def _flow_scalar(self, s: str, no: int, key: bool = False):
        if s[:1] in '\'"':
            q = s[0]
            i = 1
            while True:
                j = s.find(q, i)
                if j < 0:
                    self.fail(no, f'unterminated quote in {s!r}')
                if q == "'" and s[j + 1:j + 2] == "'":
                    i = j + 2
                    continue
                if q == '"' and s[j - 1] == '\\':
                    i = j + 1
                    continue
                return self.scalar(s[:j + 1], no), s[j + 1:]
        m = re.match(r'[^,\[\]{}]*', s)
        tok = m.group(0)
        if key:
            cut = tok.find(':')
            if cut >= 0:
                tok = tok[:cut]
        elif re.search(r':(\s|$)', tok):
            self.fail(no, f'a mapping inside a flow list: {tok!r}')
        return self.scalar(tok.strip(), no), s[len(tok):]

    # -------------------------------------------------------------- block
    def _anchor(self, rest: str, no: int):
        """(anchor name or None, rest after it)."""
        if rest.startswith('&'):
            m = re.match(r'&([^\s,\[\]{}]+)\s*(.*)$', rest)
            if not m:
                self.fail(no, f'anchor {rest!r}')
            return m.group(1), m.group(2)
        return None, rest

    def inline(self, rest: str, no: int, indent: int):
        """The value written after `key:` or `- ` on line `no` (a flow
        collection may continue on the lines below)."""
        name, rest = self._anchor(rest, no)
        if rest.startswith('*'):
            if name is not None:
                self.fail(no, 'an anchor on an alias')
            if rest[1:] not in self.anchors:
                self.fail(no, f'unknown alias {rest!r}')
            return self.anchors[rest[1:]]
        if rest == '':
            value = self.nested(indent, no)
        elif rest[0] in '[{':
            text = rest
            while not self._balanced(text):
                if self.pos >= len(self.lines):
                    self.fail(no, 'an unterminated flow collection')
                text += ' ' + self.lines[self.pos].text
                self.pos += 1
            value = self.flow(text, no)
        elif rest[0] in '|>!':
            self.fail(no, f'block scalars and tags ({rest!r})')
        else:
            value = self.scalar(rest, no)
        if name is not None:
            self.anchors[name] = value
        return value

    @staticmethod
    def _balanced(text: str) -> bool:
        depth, quote = 0, None
        for c in text:
            if quote:
                if c == quote:
                    quote = None
            elif c in '\'"':
                quote = c
            elif c in '[{':
                depth += 1
            elif c in ']}':
                depth -= 1
        return depth == 0

    def nested(self, indent: int, no: int):
        """The block under a `key:` at `indent` (a list may sit at the
        same indent), or None when there is none."""
        if self.pos >= len(self.lines):
            return None
        nxt = self.lines[self.pos]
        if nxt.indent > indent or (nxt.indent == indent
                                   and self._is_item(nxt.text)):
            return self.block(nxt.indent)
        return None

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == '-' or text.startswith('- ')

    def block(self, indent: int):
        first = self.lines[self.pos]
        if self._is_item(first.text):
            return self.block_list(indent)
        return self.block_map(indent)

    def block_list(self, indent: int):
        out = []
        while self.pos < len(self.lines):
            ln = self.lines[self.pos]
            if ln.indent < indent or (ln.indent == indent
                                      and not self._is_item(ln.text)):
                break
            if ln.indent > indent:
                self.fail(ln.no, 'bad indentation in a list')
            self.pos += 1
            rest = ln.text[1:].strip()
            if re.match(r'("[^"]*"|\'[^\']*\'|[^\'"\[{][^:]*):(\s|$)', rest):
                self.fail(ln.no, 'a mapping in a list item')
            if rest == '' or rest.startswith('&') and ' ' not in rest:
                name, _ = self._anchor(rest, ln.no)
                if self.pos < len(self.lines) \
                        and self.lines[self.pos].indent > indent:
                    value = self.block(self.lines[self.pos].indent)
                else:
                    value = None
                if name is not None:
                    self.anchors[name] = value
                out.append(value)
            else:
                out.append(self.inline(rest, ln.no, indent + 1))
        return out

    def block_map(self, indent: int):
        out = {}
        while self.pos < len(self.lines):
            ln = self.lines[self.pos]
            if ln.indent < indent:
                break
            if ln.indent > indent:
                self.fail(ln.no, 'bad indentation in a mapping')
            if self._is_item(ln.text):
                self.fail(ln.no, 'a list item inside a mapping')
            self.pos += 1
            m = re.match(r'("(?:[^"\\]|\\.)*"|\'(?:[^\']|\'\')*\'|[^\'"]'
                         r'[^:]*?)\s*:(?:\s+(.*))?$', ln.text)
            if not m:
                self.fail(ln.no, f'the line {ln.text!r}')
            key = self.scalar(m.group(1), ln.no)
            if isinstance(key, (list, dict)):
                self.fail(ln.no, 'a collection as a key')
            out[key] = self.inline((m.group(2) or '').strip(), ln.no, indent)
        return out

    def document(self):
        if not self.lines:
            return None
        first = self.lines[0]
        if first.indent:
            self.fail(first.no, 'an indented first line')
        if first.text[0] in '[{' and ':' not in first.text.split('[')[0] \
                .split('{')[0]:
            self.pos = 1
            value = self.inline(first.text, first.no, 0)
        elif ':' not in first.text and not self._is_item(first.text):
            self.pos = 1
            value = self.scalar(first.text, first.no)
        else:
            value = self.block(0)
        if self.pos < len(self.lines):
            self.fail(self.lines[self.pos].no, 'text after the document')
        return value


def loads(text: str, name: str = '<string>'):
    """The YAML document `text` as Python objects, typed as
    `yaml.safe_load` types them."""
    return _Reader(text, name).document()


def load_file(path: str):
    with open(path) as f:
        return loads(f.read(), path)
