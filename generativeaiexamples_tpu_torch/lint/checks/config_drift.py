"""GL501/GL505/GL506 config-drift: the schema, the generated docs, and string-keyed
knob references must agree.

The config tree (`config/schema.py`) is the single source of truth;
`docs/configuration.md` is generated from it and every runtime knob
reference resolves against it. Three drift shapes:

- GL501 — a schema field missing from docs/configuration.md: someone
  added a knob and skipped `scripts/gen_config_docs.py`, so deployers
  can't discover it.
- GL505 — `getattr(cfg, "…")` with a string key that resolves to no
  schema section or field: a renamed/removed knob still referenced by
  name, which `getattr(..., default)` silently papers over.
- GL506 — an `APP_<SECTION>_<FIELD>` env-var literal that matches no
  schema field's computed env name: deploy files would set it and
  nothing would read it.

The check activates only when a `config/schema.py` is among the linted
files (so linting a subtree without the schema stays quiet); docs are
looked up at `<package-parent>/docs/configuration.md`.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from generativeaiexamples_tpu_torch.lint.core import Check, Finding, Project, \
    SourceFile
from generativeaiexamples_tpu_torch.lint.checks import _util as u

CFG_NAME_RE = re.compile(r"(^|_)(cfg|config|conf)$")
APP_ENV_RE = re.compile(r"^APP_[A-Z0-9]+_[A-Z0-9]+$")
ENV_WHITELIST = {"APP_CONFIG_FILE"}


def _env_name(section: str, field: str) -> str:
    # Mirrors config/schema.py env_var_name: underscores stripped,
    # uppercased.
    strip = lambda s: s.replace("_", "").upper()  # noqa: E731
    return f"APP_{strip(section)}_{strip(field)}"


class SchemaModel:
    """Sections and fields parsed from config/schema.py's AST (no
    import: the linter must run on trees that don't import)."""

    def __init__(self, sections: Dict[str, List[str]]):
        self.sections = sections            # section -> field names
        self.all_fields: Set[str] = {f for fs in sections.values()
                                     for f in fs}
        self.env_names: Set[str] = {
            _env_name(s, f) for s, fs in sections.items() for f in fs}

    @classmethod
    def parse(cls, sf: SourceFile) -> Optional["SchemaModel"]:
        if sf.tree is None:
            return None
        classes: Dict[str, ast.ClassDef] = {
            n.name: n for n in sf.tree.body if isinstance(n, ast.ClassDef)}
        root = classes.get("AppConfig")
        if root is None:
            return None
        sections: Dict[str, List[str]] = {}
        for stmt in root.body:
            if not isinstance(stmt, ast.AnnAssign) or \
                    not isinstance(stmt.target, ast.Name):
                continue
            section = stmt.target.id
            cls_name = u.last_part(u.dotted(stmt.annotation)) or ""
            section_cls = classes.get(cls_name)
            if section_cls is None:
                continue
            sections[section] = [
                s.target.id for s in section_cls.body
                if isinstance(s, ast.AnnAssign)
                and isinstance(s.target, ast.Name)]
        return cls(sections) if sections else None


def _documented_fields(md_text: str) -> Dict[str, Set[str]]:
    """section -> backticked field names listed under its `## `section``
    header in the generated docs."""
    out: Dict[str, Set[str]] = {}
    current: Optional[str] = None
    for line in md_text.splitlines():
        m = re.match(r"##\s+`([a-z_0-9]+)`", line)
        if m:
            current = m.group(1)
            out.setdefault(current, set())
            continue
        if current and line.startswith("|"):
            for fm in re.finditer(r"`([a-z_0-9]+)`", line):
                out[current].add(fm.group(1))
    return out


class ConfigDriftCheck(Check):
    id = "GL501"
    name = "config-drift"
    severity = "error"
    describe = ("schema fields missing from docs/configuration.md; "
                "getattr/env knob references that resolve to no "
                "schema field")

    def run(self, project: Project) -> Iterable[Finding]:
        schema_sf = project.find("config/schema.py")
        if schema_sf is None:
            return
        model = SchemaModel.parse(schema_sf)
        if model is None:
            return
        yield from self._check_docs(project, schema_sf, model)
        known = set(model.sections) | model.all_fields
        for sf in project.files:
            if sf.tree is None or sf is schema_sf:
                continue
            yield from self._check_getattrs(sf, model, known)
            yield from self._check_env_literals(sf, model)

    # -- GL501: schema -> docs ---------------------------------------------

    def _check_docs(self, project: Project, schema_sf: SourceFile,
                    model: SchemaModel) -> Iterable[Finding]:
        pkg_dir = os.path.dirname(os.path.dirname(schema_sf.path))
        docs_path = os.path.join(os.path.dirname(pkg_dir), "docs",
                                 "configuration.md")
        if not os.path.isfile(docs_path):
            yield self.finding(
                schema_sf, 1,
                f"docs/configuration.md not found at {docs_path}; run "
                f"scripts/gen_config_docs.py")
            return
        with open(docs_path, encoding="utf-8", errors="replace") as fh:
            documented = _documented_fields(fh.read())
        for section, fields in sorted(model.sections.items()):
            doc_fields = documented.get(section)
            if doc_fields is None:
                yield self.finding(
                    schema_sf, 1,
                    f"config section `{section}` has no `## `{section}``"
                    f" header in docs/configuration.md; re-run "
                    f"scripts/gen_config_docs.py")
                continue
            for f in fields:
                if f not in doc_fields:
                    lineno = self._field_line(schema_sf, section, f)
                    yield self.finding(
                        schema_sf, lineno,
                        f"schema field `{section}.{f}` is not documented "
                        f"in docs/configuration.md; re-run "
                        f"scripts/gen_config_docs.py")

    def _field_line(self, sf: SourceFile, section: str, field: str) -> int:
        pat = re.compile(rf"^\s*{re.escape(field)}\s*:")
        for i, ln in enumerate(sf.lines, start=1):
            if pat.match(ln):
                return i
        return 1

    # -- GL505: string-keyed getattr ---------------------------------------

    def _check_getattrs(self, sf: SourceFile, model: SchemaModel,
                        known: Set[str]) -> Iterable[Finding]:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr"
                    and len(node.args) >= 2):
                continue
            target, key = node.args[0], node.args[1]
            if not (isinstance(key, ast.Constant)
                    and isinstance(key.value, str)):
                continue
            if not self._is_appconfig_ref(target):
                continue
            if key.value not in known:
                yield Finding(
                    check="GL505", name=self.name, severity=self.severity,
                    path=sf.rel, line=node.lineno,
                    message=(f'getattr(..., "{key.value}") resolves to no '
                             f"config section or schema field; the knob "
                             f"was renamed/removed or the key is a typo"),
                    snippet=sf.line(node.lineno))

    def _is_appconfig_ref(self, node: ast.AST) -> bool:
        """Heuristically an AppConfig(-section) value: a name like cfg/
        config/*_cfg, or an attribute chain ending in .config. Model
        configs (BertConfig etc.) conventionally live in `self.cfg`
        attributes, which are NOT matched — only bare names."""
        if isinstance(node, ast.Name):
            return bool(CFG_NAME_RE.search(node.id))
        if isinstance(node, ast.Attribute):
            return node.attr == "config"
        return False

    # -- GL506: env-var literals -------------------------------------------

    def _check_env_literals(self, sf: SourceFile,
                            model: SchemaModel) -> Iterable[Finding]:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)):
                continue
            v = node.value
            if not APP_ENV_RE.match(v) or v in ENV_WHITELIST:
                continue
            if v not in model.env_names:
                yield Finding(
                    check="GL506", name=self.name, severity=self.severity,
                    path=sf.rel, line=node.lineno,
                    message=(f'env-var literal "{v}" matches no schema '
                             f"field's APP_<SECTION>_<FIELD> name; "
                             f"setting it would be silently ignored"),
                    snippet=sf.line(node.lineno))
