"""Generate the per-module API reference under docs/api/.

The reference library links a hosted per-module API site built from its
docstrings (reference README.md:13 → ini.github.io/docs/multigrid). This is
the equivalent surface for multigrid_tpu: one markdown page per public
module, generated from live introspection so signatures never drift from the
code, committed in-repo (browsable offline and on any git host) and
published by .github/workflows/docs.yml.

Usage:  python scripts/gen_api_docs.py  [--check]

``--check`` exits non-zero if the committed pages are stale (CI guard).
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

import jax

jax.config.update('jax_platforms', 'cpu')

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
OUT = ROOT / 'docs' / 'api'

#: Packages/modules to document (public surface; private helpers stay out).
MODULES = [
    'multigrid_tpu',
    'multigrid_tpu.core',
    'multigrid_tpu.core.actions',
    'multigrid_tpu.core.constants',
    'multigrid_tpu.core.config',
    'multigrid_tpu.core.mission',
    'multigrid_tpu.core.state',
    'multigrid_tpu.envs',
    'multigrid_tpu.envs.env',
    'multigrid_tpu.envs.layout',
    'multigrid_tpu.envs.parity',
    'multigrid_tpu.envs.roomgrid',
    'multigrid_tpu.ops.step',
    'multigrid_tpu.ops.obs',
    'multigrid_tpu.parallel.vector',
    'multigrid_tpu.parallel.mesh',
    'multigrid_tpu.parallel.distributed',
    'multigrid_tpu.learn.nets',
    'multigrid_tpu.learn.ppo',
    'multigrid_tpu.learn.reference',
    'multigrid_tpu.wrappers',
    'multigrid_tpu.adapters.gym',
    'multigrid_tpu.adapters.pettingzoo',
    'multigrid_tpu.adapters.rllib',
    'multigrid_tpu.render',
    'multigrid_tpu.utils.checkpoint',
    'multigrid_tpu.utils.compile_cache',
    'multigrid_tpu.utils.enum',
    'multigrid_tpu.utils.minigrid_interface',
    'multigrid_tpu.utils.minigrid_builder',
    'multigrid_tpu.utils.misc',
    'multigrid_tpu.utils.profiling',
    'multigrid_tpu.utils.rendering',
    'multigrid_tpu.utils.struct',
]


import re

_ADDR = re.compile(r' at 0x[0-9a-f]+')


def _sig(obj) -> str:
    try:
        return _ADDR.sub('', str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return '(...)'


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ''


def _public_members(mod):
    """Names defined (or re-exported via __all__) by this module."""
    if hasattr(mod, '__all__'):
        names = list(mod.__all__)
    else:
        names = [
            n for n, v in vars(mod).items()
            if not n.startswith('_')
            and getattr(v, '__module__', None) == mod.__name__
        ]
    out = []
    for n in names:
        v = getattr(mod, n, None)
        if inspect.isclass(v) or inspect.isfunction(v) or callable(v):
            out.append((n, v))
    return out


def _render_class(name: str, cls) -> list[str]:
    lines = [f'### class `{name}{_sig(cls)}`', '']
    if _doc(cls):
        lines += [_doc(cls), '']
    bases = [b.__name__ for b in cls.__bases__ if b is not object]
    if bases:
        lines += [f'*Bases:* {", ".join(f"`{b}`" for b in bases)}', '']
    # dataclass fields
    fields = getattr(cls, '__dataclass_fields__', None)
    if fields:
        lines += ['| field | default |', '|---|---|']
        for fn, f in fields.items():
            default = (
                '' if f.default is inspect.Parameter.empty
                or type(f.default).__name__ == '_MISSING_TYPE'
                or ' at 0x' in repr(f.default)  # unstable object reprs
                else f'`{f.default!r}`')
            lines.append(f'| `{fn}` | {default} |')
        lines.append('')
    for mn, mv in sorted(vars(cls).items()):
        if mn.startswith('_') and mn != '__call__':
            continue
        if isinstance(mv, (staticmethod, classmethod)):
            mv = mv.__func__
        if inspect.isfunction(mv):
            lines += [f'#### `{name}.{mn}{_sig(mv)}`', '']
            if _doc(mv):
                lines += [_doc(mv), '']
        elif isinstance(mv, property):
            lines += [f'#### property `{name}.{mn}`', '']
            if _doc(mv):
                lines += [_doc(mv), '']
    return lines


def render_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f'# `{modname}`', '']
    if _doc(mod):
        lines += [_doc(mod), '']
    classes, functions = [], []
    for n, v in _public_members(mod):
        if inspect.isclass(v):
            classes.append((n, v))
        elif inspect.isfunction(v):
            functions.append((n, v))
    if classes:
        lines += ['## Classes', '']
        for n, v in classes:
            lines += _render_class(n, v)
    if functions:
        lines += ['## Functions', '']
        for n, v in functions:
            lines += [f'### `{n}{_sig(v)}`', '']
            if _doc(v):
                lines += [_doc(v), '']
    return '\n'.join(lines).rstrip() + '\n'


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--check', action='store_true',
                    help='verify committed pages are current')
    args = ap.parse_args()

    pages = {}
    for modname in MODULES:
        pages[modname.replace('.', '_') + '.md'] = render_module(modname)
    index = ['# multigrid_tpu API reference', '',
             'Generated by `scripts/gen_api_docs.py` — do not edit by hand.',
             '']
    for modname in MODULES:
        fn = modname.replace('.', '_') + '.md'
        mod = importlib.import_module(modname)
        first = (_doc(mod).splitlines() or [''])[0]
        index.append(f'- [`{modname}`]({fn}) — {first}')
    pages['README.md'] = '\n'.join(index) + '\n'

    if args.check:
        stale = [
            fn for fn, text in pages.items()
            if not (OUT / fn).exists() or (OUT / fn).read_text() != text
        ]
        if stale:
            print('stale API docs (run scripts/gen_api_docs.py):', stale)
            return 1
        print(f'{len(pages)} API pages current')
        return 0

    OUT.mkdir(parents=True, exist_ok=True)
    for fn, text in pages.items():
        (OUT / fn).write_text(text)
    print(f'wrote {len(pages)} pages to {OUT}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
