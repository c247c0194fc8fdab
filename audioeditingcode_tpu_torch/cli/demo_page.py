"""Build the demo (supplementary) page from the edit CLIs' results trees.

Counterpart of ``tools/build_demo_page.py``, with the same flags,
``scan_results``, ``render`` and ``render_comparison``: given the same
results trees it writes the same HTML, byte for byte. It reads the layout
the port's CLIs write (``results/<model>/<clip>/src_<...>/dec_<...>/*.wav``,
``cli/run.py``; ``cli/sdedit.py`` and ``--mode ddim`` roots as extra
lanes) and emits one self-contained page with one audio row per edit. Run
it as ``aetorch-demo-page`` or ``python -m
audioeditingcode_tpu_torch.cli.demo_page``::

  aetorch-demo-page --results results/ --out docs/supp.html \
      [--sdedit results_sdedit/] [--ddim results_ddim/] \
      [--copy-audio docs/resources/audio] [--banner "SYNTHETIC WEIGHTS"]

With ``--copy-audio`` the wavs are copied next to the page and referenced
relatively (a publishable page); without it the page links to the results
tree in place (a local preview). A host tool: no ``--device``, no torch.
With any baseline root the page is the method comparison (one column per
lane, rows keyed by clip and target prompt).
"""

from __future__ import annotations

import argparse
import dataclasses
import html
import os
import shutil
from typing import List, Optional

_PAGE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>Audio editing results — supplementary</title>
<style>
  body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 64rem;
         padding: 0 1rem; color: #222; }}
  h1 {{ font-size: 1.6rem; }}
  h2 {{ font-size: 1.2rem; margin-top: 2.5rem; border-bottom: 1px solid #ddd;
       padding-bottom: .3rem; }}
  table {{ border-collapse: collapse; width: 100%; margin: 1rem 0; }}
  th, td {{ text-align: left; padding: .45rem .6rem; vertical-align: top;
            border-bottom: 1px solid #eee; font-size: .92rem; }}
  audio {{ width: 16rem; height: 2rem; }}
  .prompt {{ font-style: italic; }}
  .cfg {{ color: #777; font-size: .8rem; white-space: nowrap; }}
  .empty {{ color: #888; margin-top: 2rem; }}
  .banner {{ background: #fff3cd; border: 1px solid #ffc107; color: #664d03;
             padding: .6rem .9rem; border-radius: .4rem; font-weight: 600; }}
  a {{ color: #0a58ca; }}
</style>
</head>
<body>
<h1>Zero-shot audio editing — supplementary results</h1>
<p><a href="index.html">&larr; back to project page</a></p>
<p>Text-based and unsupervised edits produced by the TPU-native framework
(edit-friendly DDPM inversion / posterior principal components).</p>
{body}
</body>
</html>
"""


@dataclasses.dataclass
class EditRow:
    model: str
    clip: str
    source_prompt: str
    target_prompt: str
    orig_wav: Optional[str]
    edited: List[str]  # paths of edited wavs


def _unmangle(prompt_dir: str, prefix: str) -> str:
    p = prompt_dir[len(prefix):] if prompt_dir.startswith(prefix) else prompt_dir
    p = p.split("__neg__")[0]
    return p.replace("__", " / ").replace("_", " ").strip()


def scan_results(results_dir: str) -> List[EditRow]:
    """Walk the edit CLIs' results layout (``cli/run.py``)."""
    rows: List[EditRow] = []
    for model in sorted(os.listdir(results_dir)):
        mdir = os.path.join(results_dir, model)
        if not os.path.isdir(mdir):
            continue
        for clip in sorted(os.listdir(mdir)):
            cdir = os.path.join(mdir, clip)
            if not os.path.isdir(cdir):
                continue
            for src in sorted(os.listdir(cdir)):
                sdir = os.path.join(cdir, src)
                if not os.path.isdir(sdir) or not src.startswith("src_"):
                    continue
                for dec in sorted(os.listdir(sdir)):
                    ddir = os.path.join(sdir, dec)
                    if not os.path.isdir(ddir) or not dec.startswith("dec_"):
                        continue
                    wavs = sorted(f for f in os.listdir(ddir)
                                  if f.endswith(".wav"))
                    orig = os.path.join(ddir, "orig.wav") \
                        if "orig.wav" in wavs else None
                    edited = [os.path.join(ddir, f) for f in wavs
                              if f != "orig.wav"]
                    if edited:
                        rows.append(EditRow(
                            model=model, clip=clip,
                            source_prompt=_unmangle(src, "src_"),
                            target_prompt=_unmangle(dec, "dec_"),
                            orig_wav=orig, edited=edited,
                        ))
    return rows


def scan_musicgen(root: str):
    """MusicGen baseline layout (reference: evals/utils.py:211-216 and the
    supp page's MusicGen columns): ``<root>/<clip>/prompt_<target>.wav`` —
    returns {(clip, target_prompt): wav_path}."""
    out = {}
    for clip in sorted(os.listdir(root)):
        cdir = os.path.join(root, clip)
        if not os.path.isdir(cdir):
            continue
        for f in sorted(os.listdir(cdir)):
            if f.endswith(".wav") and f.startswith("prompt_"):
                out[(clip, f[7:-4])] = os.path.join(cdir, f)
    return out


def _audio_tag(path: str) -> str:
    return (f'<audio controls preload="none" '
            f'src="{html.escape(path)}"></audio>')


def _cfg_label(fname: str) -> str:
    return html.escape(os.path.splitext(fname)[0])


def _banner_html(banner: Optional[str]) -> str:
    """Prominent provenance banner (e.g. 'SYNTHETIC WEIGHTS — plumbing
    rehearsal'): a rehearsal on synthetic weights must be impossible to
    mistake for real results."""
    if not banner:
        return ""
    return f'<p class="banner">{html.escape(banner)}</p>\n'


def render(rows: List[EditRow], out_path: str,
           copy_audio: Optional[str] = None,
           banner: Optional[str] = None) -> str:
    out_dir = os.path.dirname(os.path.abspath(out_path))

    def rel(p: str) -> str:
        if copy_audio:
            os.makedirs(copy_audio, exist_ok=True)
            dst = os.path.join(
                copy_audio, "_".join(os.path.normpath(p).split(os.sep)[-4:]))
            shutil.copyfile(p, dst)
            p = dst
        return os.path.relpath(os.path.abspath(p), out_dir)

    if not rows:
        body = ('<p class="empty">No results yet — run the editing CLIs '
                '(e.g. <code>main_run.py</code>) with real converted weights '
                'and re-run <code>tools/build_demo_page.py</code>.</p>')
        return _PAGE.format(body=_banner_html(banner) + body)

    parts = []
    for model in sorted({r.model for r in rows}):
        parts.append(f"<h2>{html.escape(model)}</h2>")
        parts.append("<table><tr><th>clip</th><th>source prompt</th>"
                     "<th>target prompt</th><th>original</th>"
                     "<th>edited</th></tr>")
        for r in [x for x in rows if x.model == model]:
            edits = "<br>".join(
                f'{_audio_tag(rel(e))}<div class="cfg">{_cfg_label(os.path.basename(e))}</div>'
                for e in r.edited)
            orig = _audio_tag(rel(r.orig_wav)) if r.orig_wav else "&mdash;"
            parts.append(
                "<tr>"
                f"<td>{html.escape(r.clip)}</td>"
                f'<td class="prompt">{html.escape(r.source_prompt) or "&mdash;"}</td>'
                f'<td class="prompt">{html.escape(r.target_prompt)}</td>'
                f"<td>{orig}</td><td>{edits}</td>"
                "</tr>")
        parts.append("</table>")
    return _PAGE.format(body=_banner_html(banner) + "\n".join(parts))


def render_comparison(method_rows, out_path: str,
                      copy_audio: Optional[str] = None,
                      banner: Optional[str] = None) -> str:
    """Method-comparison page (the reference supp.html layout: one column
    per method — ours / SDEdit / DDIM / MusicGen / MusicGen-large — plus the
    original, rows keyed by (clip, target prompt)).

    method_rows: {method_name: {(clip, target_prompt):
                  (orig_wav|None, [edited wavs])}}
    """
    out_dir = os.path.dirname(os.path.abspath(out_path))

    def rel(p: str) -> str:
        if copy_audio:
            os.makedirs(copy_audio, exist_ok=True)
            dst = os.path.join(
                copy_audio, "_".join(os.path.normpath(p).split(os.sep)[-4:]))
            shutil.copyfile(p, dst)
            p = dst
        return os.path.relpath(os.path.abspath(p), out_dir)

    methods = [m for m in ("ours", "sdedit", "ddim", "musicgen",
                           "musicgen-large") if m in method_rows]
    methods += sorted(set(method_rows) - set(methods))
    keys = sorted({k for rows in method_rows.values() for k in rows})
    if not keys:
        return _PAGE.format(body=_banner_html(banner)
                            + '<p class="empty">No results yet.</p>')

    parts = ["<h2>Method comparison</h2>",
             "<table><tr><th>clip</th><th>target prompt</th><th>original</th>"
             + "".join(f"<th>{html.escape(m)}</th>" for m in methods)
             + "</tr>"]
    for clip, target in keys:
        orig = None
        cells = []
        for m in methods:
            entry = method_rows[m].get((clip, target))
            if entry is None:
                cells.append("<td>&mdash;</td>")
                continue
            o, edited = entry
            orig = orig or o
            cells.append("<td>" + "<br>".join(
                f'{_audio_tag(rel(e))}'
                f'<div class="cfg">{_cfg_label(os.path.basename(e))}</div>'
                for e in edited) + "</td>")
        parts.append(
            "<tr>"
            f"<td>{html.escape(clip)}</td>"
            f'<td class="prompt">{html.escape(target)}</td>'
            f"<td>{_audio_tag(rel(orig)) if orig else '&mdash;'}</td>"
            + "".join(cells) + "</tr>")
    parts.append("</table>")
    return _PAGE.format(body=_banner_html(banner) + "\n".join(parts))


def _method_rows_from_tree(results_dir: str):
    """Group a CLI results tree by (clip, target prompt)."""
    out = {}
    for r in scan_results(results_dir):
        key = (r.clip, r.target_prompt)
        if key in out:  # merge multiple cfg variants of the same edit
            out[key] = (out[key][0] or r.orig_wav, out[key][1] + r.edited)
        else:
            out[key] = (r.orig_wav, list(r.edited))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Build the demo page from results trees.")
    p.add_argument("--results", required=True,
                   help="results directory root ('ours' edits)")
    p.add_argument("--sdedit", default=None,
                   help="SDEdit baseline results root (cli/sdedit.py layout)")
    p.add_argument("--ddim", default=None,
                   help="DDIM-inversion baseline results root")
    p.add_argument("--musicgen", default=None,
                   help="MusicGen baseline root (<root>/<clip>/prompt_<t>.wav)")
    p.add_argument("--musicgen_large", default=None,
                   help="MusicGen-large baseline root (same layout)")
    p.add_argument("--out", default="docs/supp.html")
    p.add_argument("--copy-audio", default=None,
                   help="copy wavs under this dir (for a publishable page)")
    p.add_argument("--banner", default=None,
                   help="prominent provenance banner at the top of the page "
                        "(e.g. 'SYNTHETIC WEIGHTS — plumbing rehearsal')")
    args = p.parse_args(argv)

    baselines = (args.sdedit, args.ddim, args.musicgen, args.musicgen_large)
    if any(baselines):
        method_rows = {"ours": _method_rows_from_tree(args.results)}
        if args.sdedit:
            method_rows["sdedit"] = _method_rows_from_tree(args.sdedit)
        if args.ddim:
            method_rows["ddim"] = _method_rows_from_tree(args.ddim)
        for name, root in (("musicgen", args.musicgen),
                           ("musicgen-large", args.musicgen_large)):
            if root:
                method_rows[name] = {k: (None, [v]) for k, v in
                                     scan_musicgen(root).items()}
        page = render_comparison(method_rows, args.out,
                                 copy_audio=args.copy_audio,
                                 banner=args.banner)
        n = sum(len(v) for v in method_rows.values())
    else:
        rows = scan_results(args.results)
        page = render(rows, args.out, copy_audio=args.copy_audio,
                      banner=args.banner)
        n = len(rows)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(page)
    print(f"[+] wrote {args.out} ({n} edit rows)")


if __name__ == "__main__":
    main()
