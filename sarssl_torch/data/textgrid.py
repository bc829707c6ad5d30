"""Minimal Praat TextGrid parser and speaker-overlap utilities (the port's own
copy of ``sarssl_tpu/data/textgrid.py``).

The reference removes speaker-overlapped segments from AMI/AISHELL-4 style
corpora using the ``textgrid`` package (utils_real_micsig.py, AISHELL4
reader). That package is not available in this environment; the TextGrid
format is plain text, so this module parses the two common encodings
(long/short form, IntervalTier only) and computes single-speaker regions.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Tuple


@dataclass
class Interval:
    xmin: float
    xmax: float
    text: str


def parse_textgrid(path_or_text: str) -> Dict[str, List[Interval]]:
    """Parse a TextGrid file (path or content) into {tier_name: intervals}."""
    if "\n" not in path_or_text:
        with open(path_or_text, errors="replace") as f:
            text = f.read()
    else:
        text = path_or_text

    tiers: Dict[str, List[Interval]] = {}
    # long form: item [k]: ... name = "spk" ... intervals [i]: xmin= xmax= text=
    item_blocks = re.split(r"item\s*\[\d+\]\s*:", text)[1:]
    for block in item_blocks:
        name_m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if name_m is None:
            continue
        name = name_m.group(1)
        ivals = []
        for m in re.finditer(
                r'xmin\s*=\s*([\d.eE+-]+)\s*\n\s*xmax\s*=\s*([\d.eE+-]+)'
                r'\s*\n\s*text\s*=\s*"([^"]*)"', block):
            ivals.append(Interval(float(m.group(1)), float(m.group(2)),
                                  m.group(3).strip()))
        if ivals:
            tiers[name] = ivals
    if tiers:
        return tiers
    return _parse_short_form(text)


def _parse_short_form(text: str) -> Dict[str, List[Interval]]:
    """Short-form TextGrid: bare values in fixed order after the header —
    per tier: class, name, xmin, xmax, n, then (xmin, xmax, text) triplets."""
    toks: List[str] = []
    for line in text.splitlines():
        t = line.strip()
        if t:
            toks.append(t)
    tiers: Dict[str, List[Interval]] = {}
    i = 0
    while i < len(toks):
        if toks[i] in ('"IntervalTier"',):
            try:
                name = toks[i + 1].strip('"')
                n = int(float(toks[i + 4]))
                j = i + 5
                ivals = []
                for _ in range(n):
                    ivals.append(Interval(float(toks[j]), float(toks[j + 1]),
                                          toks[j + 2].strip('"').strip()))
                    j += 3
                if ivals:
                    tiers[name] = ivals
                i = j
                continue
            except (IndexError, ValueError):
                break
        i += 1
    return tiers


def speech_segments(tiers: Dict[str, List[Interval]]) -> List[Tuple[float, float, str]]:
    """(start, end, speaker) for every non-empty interval across tiers."""
    out = []
    for spk, ivals in tiers.items():
        for iv in ivals:
            if iv.text:
                out.append((iv.xmin, iv.xmax, spk))
    return sorted(out)


def single_speaker_windows(intervals: List[Tuple[float, float]],
                           min_dur: float,
                           audio_duration: float) -> List[Tuple[float, float, float]]:
    """Windows free of cross-sentence overlap, reference algorithm
    (utils_real_micsig.py AISHELL4/M2MeT readers): sentences sorted by start
    time; for each sentence i, the window runs from the latest end time of
    all earlier sentences to the start of sentence i+1. Windows shorter than
    ``min_dur`` (or starting past the audio) are dropped.

    Returns [(start, end, duration)] in seconds.
    """
    sents = sorted(intervals)
    latest_end_before = []
    running = 0.0
    for st, ed in sents:
        latest_end_before.append(running)
        running = max(running, ed)
    out = []
    for i in range(len(sents) - 1):
        nxt_start = sents[i + 1][0]
        if (nxt_start - latest_end_before[i] >= min_dur
                and nxt_start < audio_duration):
            out.append((latest_end_before[i], nxt_start,
                        nxt_start - latest_end_before[i]))
    return out


def speech_intervals(tiers: Dict[str, List[Interval]]) -> List[Tuple[float, float]]:
    """All non-empty (start, end) sentence intervals across tiers."""
    return sorted((iv.xmin, iv.xmax) for ivals in tiers.values()
                  for iv in ivals if iv.text)


def non_overlapped_regions(tiers: Dict[str, List[Interval]],
                           min_dur: float = 0.0) -> List[Tuple[float, float]]:
    """Time regions where exactly one speaker is active (the reference's
    spk-overlap removal for AMI/AISHELL-4/M2MeT readers)."""
    segs = speech_segments(tiers)
    events = []
    for st, ed, _ in segs:
        events.append((st, 1))
        events.append((ed, -1))
    events.sort()
    out = []
    active = 0
    region_start = None
    for t, d in events:
        prev = active
        active += d
        if prev != 1 and active == 1:
            region_start = t
        elif prev == 1 and active != 1 and region_start is not None:
            if t - region_start >= min_dur:
                out.append((region_start, t))
            region_start = None
    return out
