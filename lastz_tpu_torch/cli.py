"""Command-line interface, compatible with the reference option surface:

    python -m lastz_tpu_torch.cli target [query] [options]

Accepts the blastz one-letter shortcuts (W=, T=, C=, K=, L=, H=, O=,
E=, X=, Y=, Z=, M=, G=, R=) and the --long options of the reference
(lastz.c:5357+), mapped onto Config.  The device is LASTZ_TORCH_DEVICE:
`cuda` (the default; an error without a card) or `cpu`.
"""

from __future__ import annotations

import sys

from .config import (
    Config, ScoreThreshold,
    GFEX_NO_EXTEND, GFEX_XDROP, GFEX_EXACT, GFEX_MISMATCH_BASE,
    HIT_SIMPLE, HIT_RECOVER,
)
from .core.seeds import SEED_12OF19, SEED_14OF22, match_seed


class UsageError(Exception):
    pass


def _unitized_int(s: str) -> int:
    """reference string_to_unitized_int: optional K/M/G suffix in
    units of 1,000."""
    orig = s
    s = s.strip()
    mult = 1
    if s and s[-1] in "KkMmGg":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9}[s[-1].lower()]
        s = s[:-1]
    try:
        return int(float(s) * mult)
    except ValueError:
        # string_to_unitized_int → suicidef (utilities.c:746)
        raise SystemExit('FAILURE: "%s" is not an integer' % orig)


def _name_spec_is_quantum(spec) -> bool:
    """reference name_spec_is_quantum (lastz.c): .qdna file suffix or
    a 'quantum' bracket action."""
    if not spec:
        return False
    bracket = spec.find("[")
    name = spec if bracket < 0 else spec[:bracket]
    if name.endswith(".qdna"):
        return True
    if bracket < 0:
        return False
    actions = spec[bracket:]
    for part in actions.strip("[]").split(","):
        if part == "quantum" or part.startswith("quantum="):
            return True
    return False


# user-selectable --format= names (reference lastz.c:6975-7482)
KNOWN_FORMATS = {
    "gfa", "gfanoscore", "lav", "lav+", "lav+text", "text+lav", "lavscore",
    "axt", "axt+", "axt:size2", "waxt", "maf", "maf+", "maf-",
    "sam", "sam-", "softsam", "softsam-",
    "cigar", "general", "general-", "segments", "mapping",
    "paf", "paf:wfmash", "blastn", "blastn-",
    "text", "ztext", "comp", "identity", "deseed", "none",
    "rdotplot", "rdotplot+score",
}


# reference option-surface aliases (lastz.c parse_options_loop): each
# maps a reference spelling onto the canonical option(s) we parse
_EXACT_ALIASES = {
    "--AXT": "--format=axt", "--AXT+": "--format=axt+",
    "--AXT:size2": "--format=axt:size2", "--WAXT": "--format=waxt",
    "--CIGAR": "--format=cigar", "--GFA": "--format=gfa",
    "--GFANOSCORE": "--format=gfanoscore",
    "--LAV": "--format=lav", "--LAV+": "--format=lav+",
    "--LAV+text": "--format=lav+text", "--text+LAV": "--format=lav+text",
    "--text+lav": "--format=lav+text", "--LAVSCORE": "--format=lavscore",
    "--MAF": "--format=maf", "--MAF+": "--format=maf+",
    "--MAF-": "--format=maf-",
    "--MAFSEGMENTS": "--format=mafsegments",
    "--MAFSEGMENTS+": "--format=mafsegments+",
    "--MAFSEGMENTS-": "--format=mafsegments-",
    "--mafsegments": "--format=mafsegments",
    "--mafsegments+": "--format=mafsegments+",
    "--mafsegments-": "--format=mafsegments-",
    "--SAM": "--format=sam", "--SAM-": "--format=sam-",
    "--SOFTSAM": "--format=softsam", "--SOFTSAM-": "--format=softsam-",
    "--SAM+EQX": "--format=sam+eqx", "--SAM+EQX-": "--format=sam+eqx-",
    "--SOFTSAM+EQX": "--format=softsam+eqx",
    "--SOFTSAM+EQX-": "--format=softsam+eqx-",
    "--sam+eqx": "--format=sam+eqx", "--softsam+eqx": "--format=softsam+eqx",
    "--all": "--help", "--ambiguousn": "--ambiguous=n",
    "--blastz": "--help", "--short": "--help", "--shortcuts": "--help",
    "-h": "--help", "-help": "--help",
    "-v": "--version", "-version": "--version",
    "--bothstrands": "--strand=both",
    "--plusstrand": "--strand=plus", "--minusstrand": "--strand=minus",
    "--strand=+": "--strand=plus", "--strand=forward": "--strand=plus",
    "--strand=-": "--strand=minus", "--strand=reverse": "--strand=minus",
    "--trans": "--transition", "--trans=1": "--transition",
    "--trans=0": "--notransition", "--transition=1": "--transition",
    "--transition=0": "--notransition", "--trans=2": "--transition=2",
    "--unitscore": "--match=1,1", "--unitscores": "--match=1,1",
    "--recoverhits": "--recoverseeds",
    "--nogx": "--nogapped",
    "--noydroptrim": "--noytrim",
    "--tryout:immediategapped": "--anyornone",
    "--tryout=immediategapped": "--anyornone",
    "--cigar": "--format=cigar",
    "--axt+": "--format=axt+", "--axt:size2": "--format=axt:size2",
    "--waxt": "--format=waxt",
    "--gfanoscore": "--format=gfanoscore", "--lav+": "--format=lav+",
    "--lav+text": "--format=lav+text", "--lavscore": "--format=lavscore",
    "--maf+": "--format=maf+",
    "--gx": "--gapped", "--gfx": "--gfextend",
    "--h": "--help",
    "--entropy=report": "--entropy",
}

# prefix aliases: reference prefix -> our prefix
_PREFIX_ALIAS_MAP = {
    "--mspthresh=": "--hspthresh=",
    "--mspthreshold=": "--hspthresh=",
    "--out=": "--output=",
    "--score=": "--scores=",
    "--mem:target=": "--allocate:target=",
    "--mem:query=": "--allocate:query=",
    "--mem:traceback=": "--allocate:traceback=",
    "--memory:target=": "--allocate:target=",
    "--memory:query=": "--allocate:query=",
    "--memory:traceback=": "--allocate:traceback=",
    "--writesegments=": "--output=",  # + segments format, below
    "--MAF=": "--maf=", "--AXT=": "--axt=",
}


def _prefix_alias(arg):
    for p, repl in _PREFIX_ALIAS_MAP.items():
        if arg.startswith(p):
            out = repl + arg[len(p):]
            if p == "--writesegments=":
                # reference goes on to format=segments (lastz.c:7259)
                return out + " --format=segments"
            return out
    return None


def _show_defaults(cfg, to_stderr=False):
    """--show=defaults (reference show defaults dump): a concise
    summary of the effective scoring/seeding defaults."""
    import sys as _s
    f = _s.stderr if to_stderr else _s.stdout
    f.write("lastz_tpu defaults:\n")
    f.write("  seed=12of19 step=1 transitions=1\n")
    f.write("  scores=HOXD70 gap_open=400 gap_extend=30\n")
    f.write("  xdrop=10*sub[A][A] ydrop=open+300*extend\n")
    f.write("  hspthresh=3000 gappedthresh=hspthresh\n")


HELP_TEXT = """\
lastz_tpu -- TPU-native local pairwise DNA aligner (LASTZ-compatible)
usage: lastz_tpu target [query] [options]

sequence specifiers (target/query):
  file[.fa|.fastq|.nib|.2bit|.hsx|.qdna], file/contig, file[actions]
  actions: multiple, subset=<names>, unmask, revcomp, backward,
           nmask=/xmask=/softmask=<intervals>, nickname=<name>,
           nameparse=<type>, separator=<ch>, quantum, <start>..<end>

seeding:        --seed=12of19|14of22|match<N>|<pattern>  --step=<N>
                --[no]transition[=2]  W=|Z=|T=  --word=<bits>
                --twins=[<min>..]<max>  --notwins  --recoverseeds
                --seedqueue=<N>  --maxwordcount=<N|pct%>
gf-extension:   --gfextend/--nogfextend  --exact=<N>  --mismatch=<N,L>
                --xdrop=<N> (X=)  --hspthresh=<score|top<pct>%> (K=)
                --entropy/--noentropy  --filter=<T,M>
chaining:       --chain  --nochain  --chain=<diag,anti> (G=/R=)
gapped:         --gapped/--nogapped  --ydrop=<N> (Y=)  --noytrim
                --gappedthresh=<score> (L=)  --allgappedbounds
                --anyornone  --queryhsplimit=<N>  --queryhspbest=<N>
                --querydepth=<N>  --debug=gapped:pairedbases=<N>
interpolation:  --inner=<score> (H=)
scoring:        --scores=<file> (Q=)  --match=<R[,P]>  --gap=<[O,]E>
                --ambiguous=n|iupac[,P]  --ball=<score|pct%>
                --infer[=<ctl>]  --inferonly[=<ctl>]  --infscores[=<f>]
filtering:      --identity/--coverage/--continuity=<min>[..<max>]
                --filter=identity|coverage|continuity:<range>
                --filter=nmatch:<N|pct%>  --filter=nmismatch:0..<N>
                --filter=ngap:0..<N>  --filter=cgap:0..<N>
masking:        --masking=<N> (M=)  --census[16|32][=<file>]
strands/self:   --strand=both|plus|minus  --self  --[no]mirror
                --notrivial
output:         --format=lav|lav+|axt[+]|maf[+|-]|sam|softsam|cigar|
                  gfa|paf|blastn|general[-]:<fields>|text|diffs|
                  rdotplot|comp|identity|istats|deseed|none
                --output=<file>  --rdotplot=/--axt=/--maf=<file>
                --markend  --readgroup=<tags>
index/capsule:  --writecapsule=<file>  --targetcapsule=<file>
                --tableonly[=count|andcount|distribution]  --showtable
misc:           --include=<file>  --yasra<N>[short]  --progress=<N>
                --verbosity=<N>  --allocate:*  --scoretype=double
                --version  --help"""


def parse_threshold(text: str) -> ScoreThreshold:
    """Parse K=/L= values: plain score, '<n>%', or 'top<n>%'."""
    t = text.strip()
    if t.lower().startswith("top") and t.endswith("%"):
        return ScoreThreshold("P", p=float(t[3:-1]) / 100.0)
    if t.endswith("c"):
        return ScoreThreshold("C", c=int(t[:-1]))
    return ScoreThreshold("S", s=int(float(t)))


def _read_options_file(path: str) -> list:
    """--include=<file>: whitespace-separated options, # comments."""
    try:
        f = open(path)
    except OSError as e:
        raise UsageError(
            f'failed to open "{path}" for reading ({e.strerror})')
    out = []
    with f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if line:
                out.extend(line.split())
    return out


# precanned expansion arguments (reference expanders[], lastz.c:559-575);
# [old (<=1.02.45), current] expansions per name
_YASRA_EXPANDERS = {
    "--yasra98": ["T=2 Z=20 --match=1,6 O=8 E=1 Y=20 K=22 L=30 --identity=98..100",
                  "T=2 Z=20 --match=1,6 O=8 E=1 Y=20 K=22 L=30 --identity=98..100 --ambiguous=n --noytrim"],
    "--yasra95": ["T=2 Z=20 --match=1,5 O=8 E=1 Y=20 K=22 L=30 --identity=95..100",
                  "T=2 Z=20 --match=1,5 O=8 E=1 Y=20 K=22 L=30 --identity=95..100 --ambiguous=n --noytrim"],
    "--yasra90": ["T=2 Z=20 --match=1,5 O=6 E=1 Y=20 K=22 L=30 --identity=90..100",
                  "T=2 Z=20 --match=1,5 O=6 E=1 Y=20 K=22 L=30 --identity=90..100 --ambiguous=n --noytrim"],
    "--yasra85": ["T=2      --match=1,2 O=4 E=1 Y=20 K=22 L=30 --identity=85..100",
                  "T=2      --match=1,2 O=4 E=1 Y=20 K=22 L=30 --identity=85..100 --ambiguous=n --noytrim"],
    "--yasra75": ["T=2      --match=1,1 O=3 E=1 Y=20 K=22 L=30 --identity=75..100",
                  "T=2      --match=1,1 O=3 E=1 Y=20 K=22 L=30 --identity=75..100 --ambiguous=n --noytrim"],
    "--yasra95short": ["T=2   --match=1,7 O=6 E=1 Y=14 K=10 L=14 --identity=95..100",
                       "T=2   --match=1,7 O=6 E=1 Y=14 K=10 L=14 --identity=95..100 --ambiguous=n --noytrim"],
    "--yasra85short": ["T=2   --match=1,3 O=4 E=1 Y=14 K=11 L=14 --identity=85..100",
                       "T=2   --match=1,3 O=4 E=1 Y=14 K=11 L=14 --identity=85..100 --ambiguous=n --noytrim"],
}


def _lastz_version_le(v: str, bound: str) -> bool:
    try:
        parts = tuple(int(x) for x in v.split("."))
        bparts = tuple(int(x) for x in bound.split("."))
        return parts <= bparts
    except ValueError:
        raise UsageError(f"{v} is not a valid lastz version number")


def parse_options(argv: list[str], cfg: Config | None = None,
                  allow_include: bool = True) -> Config:
    nested = cfg is not None
    if cfg is None:
        cfg = Config()
    positional = []
    have_with_trans = False
    have_gapped_thresh = False
    have_max_identity = False
    have_step = False
    seed_string = None
    args_parts = []

    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        args_parts.append(arg)
        val = arg.split("=", 1)[1] if "=" in arg else None

        import re as _re
        if not arg.startswith("-") and not _re.match(r"^[A-Z]=", arg):
            positional.append(arg)
            args_parts.pop()
            continue

        # one-letter blastz shortcuts
        if arg == "T=0":
            cfg.with_trans = 0
            have_with_trans = True
        elif arg == "T=1":
            seed_string = SEED_12OF19
            cfg.with_trans = 1
            have_with_trans = True
        elif arg == "T=2":
            seed_string = SEED_12OF19
            cfg.with_trans = 0
            have_with_trans = True
        elif arg == "T=3":
            seed_string = SEED_14OF22
            cfg.with_trans = 1
            have_with_trans = True
        elif arg == "T=4":
            seed_string = SEED_14OF22
            cfg.with_trans = 0
            have_with_trans = True
        elif arg.startswith("W="):
            seed_string = match_seed(int(val))
            if not have_with_trans:
                cfg.with_trans = 0
                have_with_trans = True
        elif arg.startswith("Z="):
            cfg.step = int(val)
            have_step = True
        elif arg == "C=0":
            cfg.chain = False
            cfg.gapped_extend = True
        elif arg == "C=1":
            cfg.chain = True
            cfg.gapped_extend = False
        elif arg == "C=2":
            cfg.chain = True
            cfg.gapped_extend = True
        elif arg == "C=3":
            cfg.chain = False
            cfg.gapped_extend = False
        elif arg.startswith("K="):
            cfg.hsp_threshold = parse_threshold(val)
            cfg._have_hsp = True
        elif arg.startswith("L="):
            cfg.gapped_threshold = parse_threshold(val)
            have_gapped_thresh = True
            cfg._have_gapped = True
        elif arg.startswith("H="):
            cfg.inner_threshold = int(float(val))
        elif arg.startswith("O="):
            _set_gap(cfg, open_=int(val))
        elif arg.startswith("E="):
            _set_gap(cfg, extend=int(val))
        elif arg.startswith("X="):
            cfg.x_drop = int(val)
            cfg._have_x = True
        elif arg.startswith("Y="):
            cfg.y_drop = int(val)
            cfg._have_y = True
        elif arg.startswith("M="):
            cfg.dynamic_masking = int(val)
            _fit_census_kind(cfg)
        elif arg.startswith("G="):
            cfg.chain_diag = int(val)
        elif arg.startswith("R="):
            cfg.chain_anti = int(val)
        elif arg.startswith("--seed="):
            if val == "12of19":
                seed_string = SEED_12OF19
            elif val == "14of22":
                seed_string = SEED_14OF22
            elif val.startswith("match"):
                n = val[5:].strip("()")
                seed_string = match_seed(int(n))
                if not have_with_trans:
                    cfg.with_trans = 0
                    have_with_trans = True
            else:
                seed_string = val
        elif arg in ("--transition", "--trans", "--transitions"):
            cfg.with_trans = 1
            have_with_trans = True
        elif arg in ("--transition=2", "--trans=2", "--transitions=2"):
            cfg.with_trans = 2
            have_with_trans = True
        elif arg in ("--notransition", "--notrans", "--notransitions"):
            cfg.with_trans = 0
            have_with_trans = True
        elif arg.startswith("--step="):
            cfg.step = int(val)
            have_step = True
        elif arg.startswith("--word="):
            cfg.max_index_bits = int(val)
        elif arg == "--strand=both" or arg == "--both":
            cfg.which_strand = 1
        elif arg in ("--strand=plus", "--plus"):
            cfg.which_strand = 0
        elif arg in ("--strand=minus", "--minus"):
            cfg.which_strand = -1
        elif arg == "--gfextend":
            cfg.gf_extend = GFEX_XDROP
        elif arg in ("--nogfextend", "--nogfx"):
            cfg.gf_extend = GFEX_NO_EXTEND
        elif arg in ("--justhits", "--hitsonly"):
            cfg.gf_extend = GFEX_NO_EXTEND
            cfg.gapped_extend = False
        elif arg == "--chain":
            cfg.chain = True
        elif arg == "--nochain":
            cfg.chain = False
        elif arg.startswith("--chain="):
            cfg.chain = True
            d, a = val.split(",")
            cfg.chain_diag, cfg.chain_anti = int(d), int(a)
        elif arg == "--gapped":
            cfg.gapped_extend = True
        elif arg in ("--nogapped", "--ungapped", "--nogappedextension"):
            cfg.gapped_extend = False
        elif arg.startswith("--xdrop="):
            cfg.x_drop = int(val)
            cfg._have_x = True
        elif arg.startswith("--ydrop="):
            cfg.y_drop = int(val)
            cfg._have_y = True
        elif arg == "--noytrim":
            cfg.y_drop_untrimmed = True
        elif arg.startswith("--hspthresh=") or arg.startswith("--hspthreshold="):
            cfg.hsp_threshold = parse_threshold(val)
            cfg._have_hsp = True
        elif arg.startswith("--gappedthresh=") or arg.startswith("--gappedthreshold="):
            cfg.gapped_threshold = parse_threshold(val)
            have_gapped_thresh = True
            cfg._have_gapped = True
        elif arg == "--entropy":
            cfg.entropic_hsp = True
        elif arg == "--noentropy":
            cfg.entropic_hsp = False
        elif arg in ("--self",):
            cfg.self_compare = True
            cfg.cloned_query = True
            cfg.inhibit_trivial = True
        elif arg.startswith("--shard="):
            # query sharding for multi-host farm-out (the TPU-native
            # analogue of the reference's capsule multi-process recipe,
            # capsule.c:6-15): worker i of n takes every n-th query
            try:
                i_s, n_s = val.split("/", 1)
                cfg.shard_index = int(i_s)
                cfg.shard_count = int(n_s)
            except ValueError:
                raise UsageError("--shard must look like --shard=i/n")
            if (cfg.shard_count < 1
                    or not 0 <= cfg.shard_index < cfg.shard_count):
                raise UsageError(
                    "--shard=i/n requires 0 <= i < n")
        elif arg.startswith("--band=") or arg.startswith("--bandwidth="):
            # lastz.c:7818-7827
            band = _unitized_int(val)
            if band <= 0:
                raise SystemExit("FAILURE: --band width must be positive")
            if band > 100 * 1000:  # maxBandWidth, lastz.h:40
                raise SystemExit(
                    "FAILURE: --band width (%s) cannot be more than %s"
                    % (f"{band:,}", f"{100 * 1000:,}"))
            cfg.band_width = band
        elif arg == "--mirror":
            cfg.mirror_hsp = True
        elif arg == "--nomirror":
            cfg.mirror_hsp = False
            cfg.mirror_gapped = False
        elif arg == "--notrivial":
            cfg.inhibit_trivial = True
        elif arg.startswith("--exact="):
            cfg.gf_extend = GFEX_EXACT
            cfg.hsp_threshold = ScoreThreshold("S", int(val))
            cfg._have_hsp = True
            cfg.entropic_hsp = False
        elif arg.startswith("--mismatch="):
            parts = val.split(",")
            n = int(parts[0])
            cfg.gf_extend = GFEX_MISMATCH_BASE + n
            if len(parts) > 1:
                cfg.hsp_threshold = ScoreThreshold("S", int(parts[1]))
            cfg.entropic_hsp = False
        elif arg.startswith("--twins="):
            v = val
            if ".." in v:
                lo, hi = v.split("..")
            elif ":" in v:
                lo, hi = v.split(":")
            else:
                lo, hi = "0", v
            cfg.twin_min_gap = int(lo)
            cfg.twin_max_gap = int(hi)
        elif arg == "--notwins":
            cfg.twin_min_gap = None
            cfg.twin_max_gap = None
        elif arg == "--recoverseeds":
            cfg.basic_hit_type = HIT_RECOVER
        elif arg.startswith("--filter=identity:"):
            lo, _, hi = arg.split(":", 1)[1].partition("..")
            cfg.min_identity = float(lo) / 100.0
            cfg.max_identity = float(hi) / 100.0 if hi else 1.0
            have_max_identity = True
        elif arg.startswith("--filter=coverage:"):
            lo, _, hi = arg.split(":", 1)[1].partition("..")
            cfg.min_coverage = float(lo) / 100.0
            cfg.max_coverage = float(hi) / 100.0 if hi else 1.0
        elif arg.startswith("--filter=continuity:"):
            lo, _, hi = arg.split(":", 1)[1].partition("..")
            cfg.min_continuity = float(lo) / 100.0
            cfg.max_continuity = float(hi) / 100.0 if hi else 1.0
        elif arg.startswith("--filter=nmatch:") or arg.startswith("--matchcount="):
            v = arg.split(":", 1)[1] if ":" in arg else val
            if v.endswith("%"):
                cfg.min_match_count_ratio = float(v[:-1]) / 100.0
            else:
                cfg.min_match_count = _unitized_int(v)
                if cfg.min_match_count <= 0:
                    raise UsageError("--filter=nmatch must be positive")
        elif arg.startswith("--filter=nmismatch:"):
            v = arg.split(":", 1)[1]
            if not (v.startswith("..") or v.startswith("0..")):
                raise UsageError("use --filter=nmismatch:0..<max>")
            cfg.max_mismatch_count = _unitized_int(v.split("..", 1)[1])
        elif arg.startswith("--filter=ngap:"):
            v = arg.split(":", 1)[1]
            if not (v.startswith("..") or v.startswith("0..")):
                raise UsageError("use --filter=ngap:0..<max>")
            cfg.max_separate_gaps_count = int(v.split("..", 1)[1])
        elif arg.startswith("--filter=cgap:"):
            v = arg.split(":", 1)[1]
            if not (v.startswith("..") or v.startswith("0..")):
                raise UsageError("use --filter=cgap:0..<max>")
            cfg.max_gap_columns_count = int(v.split("..", 1)[1])
        elif arg.startswith("--filter="):
            parts = val.split(",")
            if len(parts) == 2:
                cfg.max_transversions = int(parts[0])
                cfg.min_matches = int(parts[1])
            else:
                cfg.min_matches = int(parts[0])
        elif arg.startswith("--masking="):
            cfg.dynamic_masking = int(val)
            _fit_census_kind(cfg)
        elif (arg.startswith("--outputmasking=")
              or arg.startswith("--outputmasking:dynamic=")):
            # masked-interval report files (lastz.c:6585-6617)
            if cfg.masking_filename is not None:
                raise UsageError(
                    f'Duplicated or conflicting option "{arg}"')
            cfg.masking_filename = arg.split("=", 1)[1]
            cfg.masking_3fields = False
        elif (arg.startswith("--outputmasking+=")
              or arg.startswith("--outputmasking+:dynamic=")):
            if cfg.masking_filename is not None:
                raise UsageError(
                    f'Duplicated or conflicting option "{arg}"')
            cfg.masking_filename = arg.split("=", 1)[1]
            cfg.masking_3fields = True
        elif arg.startswith("--outputmasking:soft="):
            if cfg.soft_masked_filename is not None:
                raise UsageError(
                    f'Duplicated or conflicting option "{arg}"')
            cfg.soft_masked_filename = arg.split("=", 1)[1]
            cfg.soft_masked_3fields = False
        elif arg.startswith("--outputmasking+:soft="):
            if cfg.soft_masked_filename is not None:
                raise UsageError(
                    f'Duplicated or conflicting option "{arg}"')
            cfg.soft_masked_filename = arg.split("=", 1)[1]
            cfg.soft_masked_3fields = True
        elif arg == "--census" or arg == "--census=on":
            cfg.report_census = True
            if not cfg.census_kind:
                cfg.census_kind = "B"
        elif arg in ("--nocensus", "--census=off"):
            cfg.report_census = False
        elif arg.startswith("--census="):
            cfg.report_census = True
            if not cfg.census_kind:
                cfg.census_kind = "B"
            cfg.census_filename = val
        elif arg == "--census16" or arg.startswith("--census16="):
            if cfg.dynamic_masking >= 65535:
                raise SystemExit(
                    "--census16 can't support --masking > %d"
                    % (65535 - 1))
            cfg.report_census = True
            cfg.census_kind = "W"
            if "=" in arg:
                cfg.census_filename = val
        elif arg == "--census32" or arg.startswith("--census32="):
            cfg.report_census = True
            cfg.census_kind = "L"
            if "=" in arg:
                cfg.census_filename = val
        elif arg.startswith("--inner="):
            cfg.inner_threshold = int(float(val))
        elif arg.startswith("--identity="):
            lo, _, hi = val.partition("..")
            cfg.min_identity = float(lo) / 100.0
            cfg.max_identity = float(hi) / 100.0 if hi else 1.0
            have_max_identity = True
        elif arg.startswith("--coverage="):
            lo, _, hi = val.partition("..")
            cfg.min_coverage = float(lo) / 100.0
            cfg.max_coverage = float(hi) / 100.0 if hi else 1.0
        elif arg.startswith("--continuity="):
            lo, _, hi = val.partition("..")
            cfg.min_continuity = float(lo) / 100.0
            cfg.max_continuity = float(hi) / 100.0 if hi else 1.0
        elif arg.startswith("--format="):
            fmt = val
            if fmt.startswith(("general:", "gen:")):
                from .out.genpaf import parse_genpaf_keys
                cfg.output_format = "general"
                cfg.output_info = parse_genpaf_keys(fmt.split(":", 1)[1])
            elif fmt.startswith(("general-:", "gen-:")):
                from .out.genpaf import parse_genpaf_keys
                cfg.output_format = "general-"
                cfg.output_info = parse_genpaf_keys(fmt.split(":", 1)[1])
            elif fmt in ("diff", "diffs", "difference", "differences"):
                cfg.output_format = "differences"
            elif fmt in ("diff-", "diffs-", "difference-", "differences-"):
                cfg.output_format = "differences-"
            elif fmt in ("rdotplot", "rdotplot+score"):
                cfg.output_format = fmt
                cfg.de_gapify_output = True
            elif fmt in ("mafsegments", "mafsegments+",
                         "mafsegments-"):
                cfg.output_format = {"mafsegments": "maf",
                                     "mafsegments+": "maf+",
                                     "mafsegments-": "maf-"}[fmt]
                cfg.de_gapify_output = True
            elif fmt == "zerotext":
                cfg.output_format = "ztext"
            elif fmt in ("istats", "infstats") or (
                    (fmt.startswith("istats(") or fmt.startswith("infstats("))
                    and fmt.endswith(")")):
                # inference stats: defaults the identity cap to 70%
                # (lastz.c:7447-7473)
                cfg.output_format = "istats"
                if "(" in fmt:
                    pct = fmt[fmt.index("(") + 1 : -1].rstrip("%")
                    try:
                        pct_val = float(pct)
                    except ValueError:
                        raise UsageError(f"unknown format {val}")
                    if not 0 <= pct_val <= 100:
                        raise UsageError(f"unknown format {val}")
                    cfg.max_identity = pct_val / 100.0
                    have_max_identity = True
                elif not have_max_identity:
                    cfg.max_identity = 0.70
            elif fmt.lower().replace("+eqx", "") in (
                    "sam", "sam-", "softsam", "softsam-"):
                # plain --format=sam is HARD-masked; +eqx turns on =/X
                # cigar runs (lastz.c:7170-7260)
                base = fmt.lower()
                if "+eqx" in base:
                    cfg.sam_mark_mismatches = True
                    base = base.replace("+eqx", "")
                if base in ("sam", "sam-"):
                    base = "hard" + base
                cfg.output_format = base
            elif fmt in KNOWN_FORMATS:
                cfg.output_format = fmt
            else:
                raise UsageError(f"unknown format {fmt}")
        elif arg == "--gfa":
            cfg.output_format = "gfa"
        elif arg == "--lav":
            cfg.output_format = "lav"
        elif arg == "--axt":
            cfg.output_format = "axt"
        elif arg == "--maf":
            cfg.output_format = "maf"
        elif arg == "--maf-":
            cfg.output_format = "maf-"
        elif (arg.lower().startswith("--sam")
              or arg.lower().startswith("--softsam")) and arg.lower()[2:] \
                .replace("+eqx", "") in ("sam", "sam-",
                                         "softsam", "softsam-"):
            # bare shorthands --sam[+eqx][-] / --softsam[+eqx][-]
            # (lastz.c:7168-7250); mixed case is NOT accepted upstream
            # but all-lower/all-upper are
            low = arg[2:].lower()
            if "+eqx" in low:
                cfg.sam_mark_mismatches = True
                low = low.replace("+eqx", "")
            cfg.output_format = ("hard" + low if low in ("sam", "sam-")
                                 else low)
        elif arg.startswith("--segments="):
            cfg.segments_filename = val
        elif arg.startswith("--anchors="):
            cfg.segments_filename = val  # alias (reference synonym)
        elif arg.startswith("--scores=") or arg.startswith("Q="):
            from .core.scoring import read_score_file
            cfg._have_score_file = True
            info = read_score_file(val)
            cfg.scoring = info["scoring"]
            if "x_drop" in info:
                cfg.x_drop = info["x_drop"]
            if "y_drop" in info:
                cfg.y_drop = info["y_drop"]
            if "hsp_threshold" in info:
                cfg.hsp_threshold = ScoreThreshold("S", info["hsp_threshold"])
            if "gapped_threshold" in info:
                cfg.gapped_threshold = ScoreThreshold(
                    "S", info["gapped_threshold"])
                have_gapped_thresh = True
            if "step" in info:
                cfg.step = info["step"]
            if "seed" in info:
                seed_string = info["seed"]
            # ball score from the score file applies only if the
            # command line didn't set one (lastz.c:9149-9155)
            if cfg.ball_score < 0 and cfg.ball_score_factor < 0:
                if "ball" in info:
                    cfg.ball_score = info["ball"]
                elif "ball_factor" in info:
                    cfg.ball_score_factor = info["ball_factor"]
        elif arg.startswith("--match="):
            # --match=<reward>[,<penalty>]: unit scoring matrix; many
            # defaults derive from it at end of parse (lastz.c:9169-9236)
            parts = val.split(",")
            cfg._unit_match = int(parts[0])
            cfg._unit_mismatch = -(int(parts[1]) if len(parts) > 1
                                   else int(parts[0]))
            if cfg._unit_match <= 0:
                raise UsageError("match reward must be positive")
        elif arg.startswith("--gap="):
            if "," in val:
                o, e = val.split(",")
                _set_gap(cfg, open_=int(o), extend=int(e))
            else:
                _set_gap(cfg, extend=int(val))
        elif arg.startswith("--ambiguous=") or arg.startswith("--ambig="):
            parts = val.split(",")
            kind = parts[0].lower()
            if kind in ("n", "iupac"):
                cfg.n_is_ambiguous = True
                cfg.allow_ambi_dna = kind == "iupac"
                # one number => mismatch penalty; two => match,mismatch
                if len(parts) == 2:
                    cfg.ambi_mismatch = int(parts[1])
                elif len(parts) >= 3:
                    cfg.ambi_match = int(parts[1])
                    cfg.ambi_mismatch = int(parts[2])
            else:
                raise UsageError(f"unknown ambiguity kind {kind}")
        elif arg.startswith("--maxwordcount="):
            if val.endswith("%"):
                cfg.word_count_keep = float(val[:-1]) / 100.0
            else:
                cfg.word_count_limit = int(val)
        elif arg == "--markend":
            cfg.end_comment = True
        elif arg.startswith("--output="):
            cfg.output_filename = val
        elif arg.startswith("--rdotplot+score="):
            cfg.dotplot_filename = val
            cfg.dotplot_keys = "rdotplot+score"
        elif arg.startswith("--rdotplot="):
            cfg.dotplot_filename = val
            cfg.dotplot_keys = "rdotplot"
        elif arg.startswith("--axt="):
            cfg.axt_filename = val
        elif arg.startswith("--maf="):
            cfg.maf_filename = val
        elif arg in ("--anyornone", "--stopafterone"):
            cfg.hsp_immediate = True
            cfg.search_limit = 1
            cfg.search_limit_warn = False
            cfg.search_limit_keep = False
        elif arg.startswith("--limitperquery=") or arg.startswith("--stopafter="):
            # (lastz.c:5975-5986) sets hspImmediate, unlike --queryhsplimit
            n = int(val)
            if n <= 0:
                raise SystemExit(
                    "FAILURE: limit for --limitperquery must be positive")
            cfg.hsp_immediate = True
            cfg.search_limit = n
            cfg.search_limit_warn = False
            cfg.search_limit_keep = False
        elif (arg.startswith("--queryhsplimit=")
              or arg.startswith("--queryhsplimit+=")):
            # --queryhsplimit[+]=[[no]warn:]<n> (lastz.c:5988-6048);
            # unlike --limitperquery this does NOT set hspImmediate; the
            # '+'/keep forms report alignments up to the limit instead of
            # discarding the whole query
            # exact prefix cascade: note the reference parses the keep:
            # (non-plus) form from the first '=' — so "--queryhsplimit=
            # keep:<n>" actually FAILS with '"keep:<n>" is not an integer'
            if (arg.startswith("--queryhsplimit=keep,nowarn:")
                    or arg.startswith("--queryhsplimit+=nowarn:")):
                cfg.search_limit_warn = False
                cfg.search_limit_keep = True
                v = arg.split(":", 1)[1]
            elif arg.startswith("--queryhsplimit+=warn:"):
                cfg.search_limit_warn = True
                cfg.search_limit_keep = True
                v = arg.split(":", 1)[1]
            elif (arg.startswith("--queryhsplimit=keep:")
                    or arg.startswith("--queryhsplimit+=")):
                cfg.search_limit_warn = True
                cfg.search_limit_keep = True
                v = arg.split("=", 1)[1]
            elif arg.startswith("--queryhsplimit=nowarn:"):
                cfg.search_limit_warn = False
                cfg.search_limit_keep = False
                v = arg.split(":", 1)[1]
            elif arg.startswith("--queryhsplimit=warn:"):
                cfg.search_limit_warn = True
                cfg.search_limit_keep = False
                v = arg.split(":", 1)[1]
            else:
                cfg.search_limit_warn = True
                cfg.search_limit_keep = False
                v = arg.split("=", 1)[1]
            n = _unitized_int(v)
            if n <= 0:
                raise SystemExit(
                    "FAILURE: --queryhsplimit must be positive")
            cfg.search_limit = n
            if cfg.num_best_hsps != 0:
                raise UsageError(
                    f"can't use {arg} with --queryhspbest")
        elif arg.startswith("--readgroup="):
            cfg.read_group = val
        elif arg.startswith("--allocate:traceback=") or arg.startswith("--traceback="):
            t = val.upper()
            mult = 1
            if t.endswith("M"):
                mult = 1 << 20
                t = t[:-1]
            elif t.endswith("K"):
                mult = 1 << 10
                t = t[:-1]
            elif t.endswith("G"):
                mult = 1 << 30
                t = t[:-1]
            cfg.traceback_mem = int(float(t) * mult)
        elif arg.startswith("--include="):
            # read options from a file (reference parse_options_file,
            # lastz.c:7612); nested inclusion is not allowed
            if not allow_include:
                raise UsageError(f"nested inclusion is not allowed ({arg})")
            parse_options(_read_options_file(val), cfg=cfg,
                          allow_include=False)
        elif arg.startswith("--yasra"):
            # precanned expansion arguments (lastz.c:559-575)
            exp = _YASRA_EXPANDERS.get(arg.split(":", 1)[0])
            if exp is None:
                raise UsageError('Can%st understand "%s"' % (chr(39), arg))
            old = ":" in arg and _lastz_version_le(arg.split(":", 1)[1],
                                                   "1.02.45")
            parse_options(exp[0 if old else 1].split(),
                          cfg=cfg, allow_include=False)
        elif arg == "--tableonly" or arg.startswith("--tableonly="):
            cfg.do_seed_search = False
            kind = val or "table"
            cfg.show_pos_table = {
                "table": "table", "count": "counts",
                "andcount": "withcounts", "distribution": "distribution",
                "stop": "",
            }.get(kind)
            if cfg.show_pos_table is None:
                raise UsageError('Can%st understand "%s"' % (chr(39), arg))
        elif arg == "--showtable":
            cfg.show_pos_table = "table"
        elif arg == "--showtable=count":
            cfg.show_pos_table = "counts"
        elif arg.startswith("--verbosity="):
            cfg.verbosity = max(0, min(10, int(val)))
        elif arg == "v=0":
            cfg.verbosity = 0
        elif arg == "v=1":
            cfg.verbosity = 10
        elif arg.startswith("--progress="):
            cfg.progress = int(val)
        elif arg in ("--stats", "--stats=") or arg.startswith("--stats="):
            # per-module counters, the equivalent of the reference's
            # collect_stats build (lastz.c:1796-1808); release
            # reference builds only print a notice here
            cfg.stats_filename = val or ""
        elif arg == "--nostats":
            cfg.stats_filename = None
        elif arg.startswith("--queryhspbest="):
            n = _unitized_int(val)
            if n <= 0:
                raise UsageError("--queryhspbest must be positive")
            if cfg.search_limit != 0:
                raise UsageError(
                    f"can't use {arg} with --queryhsplimit")
            cfg.num_best_hsps = n
        elif arg.startswith("--querydepth="):
            v = val
            cfg.overly_paired_warn = True
            cfg.overly_paired_keep = False
            while ":" in v:
                mode, v = v.split(":", 1)
                if mode == "nowarn":
                    cfg.overly_paired_warn = False
                elif mode == "keep":
                    cfg.overly_paired_keep = True
                elif mode == "keep,nowarn":
                    cfg.overly_paired_warn = False
                    cfg.overly_paired_keep = True
                elif mode == "discard":
                    cfg.overly_paired_keep = False
                else:
                    raise UsageError('Can%st understand "%s"' % (chr(39), arg))
            cfg.max_paired_depth = max(0.0, float(v))
        elif arg.startswith("--debug=gapped:pairedbases=keep:"):
            # (lastz.c:8145-8162)
            cfg.overly_paired_warn = True
            cfg.overly_paired_keep = True
            cfg.max_paired_bases = _unitized_int(arg.rsplit(":", 1)[1])
        elif arg.startswith("--debug=gapped:pairedbases="):
            cfg.overly_paired_warn = True
            cfg.overly_paired_keep = False
            cfg.max_paired_bases = _unitized_int(arg.split("=", 2)[2])
        elif arg.startswith("--seedqueue="):
            cfg.seed_queue_size = int(val)
        elif arg in ("--norecoverseeds", "--norecoverhits"):
            cfg.basic_hit_type = HIT_SIMPLE
        elif arg == "--allgappedbounds":
            cfg.gapped_all_bounds = True
        elif arg.startswith("--allocate:") or arg.startswith("--alloc:"):
            pass  # preallocation hints; our arrays grow dynamically
        elif arg.startswith("--ball="):
            # quantum seeding threshold (lastz.c:6410-6426)
            if val.endswith("%"):
                cfg.ball_score = 0
                cfg.ball_score_factor = float(val[:-1]) / 100.0
            else:
                cfg.ball_score = int(float(val))
        elif arg.startswith("--chores="):
            cfg.chores_filename = val
        elif arg.startswith("--writecapsule="):
            if cfg.read_capsule:
                raise UsageError(
                    "can't use --writecapsule with --targetcapsule")
            cfg.capsule_filename = val
            cfg.write_capsule = True
        elif arg.startswith("--targetcapsule="):
            if cfg.write_capsule:
                raise UsageError(
                    "can't use --targetcapsule with --writecapsule")
            cfg.capsule_filename = val
            cfg.read_capsule = True
        elif arg == "--infer" or arg.startswith("--infer="):
            cfg.infer_scores = True
            cfg.infer_only = False
            if val is not None:
                cfg.infer_control_filename = val
        elif arg == "--inferonly" or arg.startswith("--inferonly="):
            cfg.infer_scores = True
            cfg.infer_only = True
            if val is not None:
                cfg.infer_control_filename = val
        elif arg == "--infscores" or arg.startswith("--infscores="):
            cfg.infer_scores = True
            if val is not None:
                cfg.infer_scores_filename = val
        elif arg in ("--doublescore", "--scoretype=double"):
            # equivalent of the reference's lastz_D build
            cfg.score_type = "D"
            args_parts.pop()
        # -- reference option-surface aliases (lastz.c parse_options_loop)
        elif arg in _EXACT_ALIASES:
            parse_options(_EXACT_ALIASES[arg].split(), cfg=cfg,
                          allow_include=False)
        elif _prefix_alias(arg) is not None:
            parse_options(_prefix_alias(arg).split(), cfg=cfg,
                          allow_include=False)
        elif arg in ("--eqx", "--EQX", "--mark:eqx", "--mark:EQX",
                     "--mark:mismatches"):
            # minimap2-style =/X cigars in SAM output (lastz.c:7160)
            cfg.sam_mark_mismatches = True
        elif arg in ("--noxtrim", "--noxdroptrim"):
            # the reference itself rejects these (lastz.c:6296-6298)
            raise UsageError("sorry, --noxtrim not implemented yet")
        elif arg in ("--runtime", "--noruntime"):
            pass  # wall-clock report to stderr only; no output effect
        elif arg == "--notruncationreport":
            cfg.no_truncation_report = True
        elif arg == "--version:noerror":
            print("lastz_tpu 0.1.0")
            sys.exit(0)
        elif arg == "--rawhits":
            # report every seed hit unfiltered (lastz.c:5724,9821-9824)
            cfg.raw_hits = True
        elif arg == "--show=defaults" or arg == "--show=defaults:stderr":
            _show_defaults(cfg, to_stderr=arg.endswith(":stderr"))
        elif arg.startswith(("--action:target=", "--action1=")):
            cfg.target_actions.append(val)
        elif arg.startswith(("--action:query=", "--action2=")):
            cfg.query_actions.append(val)
        elif arg == "--progress":
            cfg.progress = 1
        elif arg.startswith("--progress+masking"):
            cfg.progress = _unitized_int(val) if val is not None else 1
        elif arg.startswith("--progress:"):
            # stage-progress debug streams; we report via --progress=
            sys.stderr.write(f"lastz_tpu: {arg.split('=')[0]} ignored\n")
        elif arg == "--debug" or arg.startswith("--debug="):
            # the reference's unadvertised debug-print switches; the
            # queryprogress family maps onto --progress, the rest only
            # change stderr diagnostics we do not produce
            dv = val or ""
            if dv.startswith("queryprogress"):
                _, _, n = dv.partition("=")
                cfg.progress = _unitized_int(n) if n else 1
            else:
                sys.stderr.write(
                    f"lastz_tpu: --debug={dv} has no effect here\n")
        elif arg == "--nofilter":
            cfg.min_matches = -1  # lastz.c:5615
        elif arg in ("--nolaj", "--laj"):
            pass  # laj-compatibility stanzas are not emitted anyway
        elif arg == "--entropy=report":
            cfg.entropic_hsp = True
            cfg.report_entropy = True  # lastz.c:6447-6450
        elif arg.startswith("--expand="):
            # text-format context columns (lastz.c:7538-7546)
            n = int(val)
            if n < 0:
                raise SystemExit("FAILURE: --expand cannot be negative")
            if n >= 1000:
                raise SystemExit(
                    "FAILURE: --expand must be less than 1000")
            cfg.text_context = n
        elif arg in ("--force:reportfilteredhsps",
                     "--force=reportfilteredhsps"):
            cfg.force_report_filtered_hsps = True
        elif arg.startswith("--gexverbosity="):
            pass  # unadvertised gapped-extend debug verbosity
        elif arg.startswith("--density="):
            # densityFiltering is a non-default reference build option
            raise UsageError(
                "--density is not implemented in this build")
        elif arg == "--yasra":
            raise UsageError('Can%st understand "%s"' % (chr(39), arg))
        elif arg == "--version":
            # the reference exits EXIT_FAILURE here so batch scripts
            # notice; --version:noerror exits 0 (lastz.c:7836-7841)
            print("lastz_tpu 0.1.0")
            sys.exit(1)
        elif arg == "--help" or arg.startswith("--help="):
            print(HELP_TEXT)
            sys.exit(0)
        elif arg.startswith("--"):
            raise UsageError('Can%st understand "%s"' % (chr(39), arg))
        else:
            raise UsageError('Can%st understand "%s"' % (chr(39), arg))

    if seed_string is not None:
        cfg.seed_string = seed_string
    if nested:
        # options files / expanders contribute options only; the
        # surrounding command line owns positionals and finalization
        if positional:
            raise UsageError(
                "sequence files are not allowed inside included options")
        return cfg

    # --match=<m>,<mm> unit scores: derive thresholds/drops relative to
    # the match/mismatch scores (lastz.c:9169-9236); a score file wins
    if getattr(cfg, "_unit_match", None) is not None \
            and not getattr(cfg, "_have_score_file", False):
        import math

        import numpy as _np

        from .core.scoring import new_dna_score_set
        um = cfg._unit_match
        umm = cfg._unit_mismatch  # negative
        ceil = (math.ceil if cfg.score_type == "I" else (lambda x: x))
        scratch = int(ceil(30.0 * um))  # unitScores_thresh
        gap_open = (cfg.scoring.gap_open
                    if cfg.scoring is not None and cfg.scoring.gap_open_set
                    else int(ceil(3.25 * -umm)))      # unitScores_open
        gap_extend = (cfg.scoring.gap_extend
                      if cfg.scoring is not None
                      and cfg.scoring.gap_extend_set
                      else int(ceil(0.24375 * -umm)))  # unitScores_extend
        if not getattr(cfg, "_have_hsp", False):
            cfg.hsp_threshold = ScoreThreshold("S", s=scratch)
        if (not getattr(cfg, "_have_gapped", False)
                and cfg.gf_extend == GFEX_EXACT):
            cfg.gapped_threshold = ScoreThreshold("S", s=scratch)
        if not getattr(cfg, "_have_x", False) and not cfg.infer_scores:
            cfg.x_drop = int(ceil(10.0 * math.sqrt(-umm)))
        if not getattr(cfg, "_have_y", False) and not cfg.infer_scores:
            cfg.y_drop = 2 * cfg.x_drop
        tmpl = _np.full((4, 4), umm, dtype=_np.int64)
        _np.fill_diagonal(tmpl, um)
        had_open = cfg.scoring is not None and cfg.scoring.gap_open_set
        had_extend = cfg.scoring is not None and cfg.scoring.gap_extend_set
        cfg.scoring = new_dna_score_set(
            template=tmpl,
            bad_score=int(-10.0 * -umm),   # unitScores_X
            fill_score=int(-1.0 * -umm),   # unitScores_fill
            gap_open=gap_open, gap_extend=gap_extend)
        cfg.scoring.gap_open_set = had_open
        cfg.scoring.gap_extend_set = had_extend

    if cfg.read_capsule:
        # the one positional (if any) is the query (lastz.c:7755-7770)
        if len(positional) >= 2:
            raise UsageError("can't use --targetcapsule with two queries")
        if len(positional) == 1:
            cfg.seq2_filename = positional[0]
        if have_step:
            raise UsageError("can't use --step with --targetcapsule")
        if seed_string is not None:
            raise UsageError("can't use --seed with --targetcapsule")
        if cfg.dynamic_masking > 0:
            raise UsageError("can't use --masking with --targetcapsule")
        if cfg.word_count_limit > 0 or cfg.word_count_keep > 0:
            raise UsageError("can't use --maxwordcount with --targetcapsule")
        if cfg.max_index_bits != 28:
            raise UsageError("can't use --word with --targetcapsule")
    elif cfg.write_capsule:
        if len(positional) >= 2:
            raise UsageError(
                "--writecapsule can't be used when you specify a query file")
        if cfg.infer_scores:
            raise UsageError("can't use --infer with --writecapsule")
        if len(positional) >= 1:
            cfg.seq1_filename = positional[0]
    else:
        if len(positional) >= 1:
            cfg.seq1_filename = positional[0]
        if len(positional) >= 2:
            cfg.seq2_filename = positional[1]
    if cfg.self_compare and cfg.seq2_filename is None:
        cfg.seq2_filename = cfg.seq1_filename

    if cfg.masking_filename is not None and cfg.dynamic_masking == 0:
        # lastz.c:8866-8870
        raise UsageError("--outputmasking requires --masking")

    if cfg.chores_filename or (cfg.seq2_filename
                               and "chores=" in cfg.seq2_filename):
        if cfg.infer_scores:
            raise UsageError("can't use [chores] with --infer[only]")
        if cfg.segments_filename:
            raise UsageError("can't use [chores] with --segments")

    # quantum DNA detection (reference name_spec_is_quantum, lastz.c)
    cfg.target_is_quantum = _name_spec_is_quantum(cfg.seq1_filename)
    cfg.query_is_quantum = _name_spec_is_quantum(cfg.seq2_filename)

    # --rawhits conflicts (lastz.c:9821-9824)
    if cfg.raw_hits:
        if cfg.twin_min_span > 0:
            raise UsageError("--rawhits can't be used with --twins")
        if cfg.gf_extend != GFEX_NO_EXTEND:
            raise UsageError("--rawhits can't be used with --gfextend")

    # --action:target=/--action:query= append to the sequence specs
    if cfg.target_actions and cfg.seq1_filename:
        from .pipeline import Pipeline
        cfg.seq1_filename = Pipeline._apply_actions(
            cfg.seq1_filename, cfg.target_actions)
    if cfg.query_actions and cfg.seq2_filename:
        from .pipeline import Pipeline
        cfg.seq2_filename = Pipeline._apply_actions(
            cfg.seq2_filename, cfg.query_actions)

    # --band= sanity checks (lastz.c:8757-8777)
    if cfg.band_width != 0:
        if not cfg.self_compare:
            raise UsageError("--band=<width> requires --self")
        if cfg.which_strand != 0:
            raise UsageError("--band=<width> requires --strand=plus")
        if cfg.target_is_quantum or cfg.query_is_quantum:
            raise UsageError("--band=<width> cannot be used with quantum DNA")
        if cfg.infer_scores:
            raise UsageError(
                "--band=<width> cannot be used with scoring inference")
        if cfg.segments_filename is not None:
            sys.stderr.write(
                "WARNING. --band=<width> is ignored when --segments is"
                " specified\n")
    if cfg.target_is_quantum or cfg.query_is_quantum:
        if have_with_trans and cfg.with_trans != 0:
            raise UsageError("can't use --transitions with quantum DNA")
        cfg.with_trans = 0
        if cfg.output_format.startswith(("axt", "waxt")):
            raise UsageError("--axt doesn't support quantum DNA")
        if cfg.output_format.startswith("maf"):
            raise UsageError("--maf doesn't support quantum DNA")
        if cfg.output_format in ("general", "general-") and cfg.output_info:
            # text/nucleotide fields can't render quantum symbols
            # (lastz.c:9496-9527)
            for key, fname in (("T", "text1"), ("t", "text2")):
                if key in cfg.output_info:
                    raise UsageError(
                        f"--format=general:{fname} doesn't support"
                        " quantum DNA")
            if cfg.query_is_quantum:
                for key, fname in (("p", "nucs2"), ("q", "quals2")):
                    if key in cfg.output_info:
                        raise UsageError(
                            f"--format=general:{fname} doesn't support"
                            " quantum DNA")
        # (lastz.c:8652-8667)
        if cfg.infer_scores:
            raise SystemExit(
                "FAILURE: scoring inference cannot be performed with"
                " quantum DNA")
        if cfg.min_identity > 0 or cfg.max_identity < 1:
            raise SystemExit(
                "FAILURE: identity filtering cannot be used with"
                " quantum DNA")
        if cfg.min_match_count_ratio != 0 or cfg.min_match_count > 0:
            raise SystemExit(
                "FAILURE: match count filtering cannot be used with"
                " quantum DNA")
        if cfg.max_mismatch_count > 0:
            raise SystemExit(
                "FAILURE: mismatch count filtering cannot be used with"
                " quantum DNA")
        if cfg.output_format == "identity":
            raise SystemExit(
                "FAILURE: --format=identity cannot be used with"
                " quantum DNA")
    elif cfg.ball_score >= 0 or cfg.ball_score_factor >= 0:
        raise UsageError("--ball can't be used with DNA target and query")

    # search-limit conflicts (lastz.c:8883-8924)
    if cfg.hsp_immediate:
        if cfg.infer_scores:
            raise UsageError("can't use --anyornone with --infer[only]")
        if cfg.inner_threshold > 0:
            raise UsageError("can't use --anyornone with --inner")
        if cfg.segments_filename is not None:
            raise UsageError("can't use --anyornone with --segments")
        if cfg.hsp_threshold.t != "S":
            raise UsageError(
                "can't use --anyornone with adaptive hsp score threshold")
        if cfg.chain:
            raise UsageError("can't use --anyornone with --chain")
    if cfg.search_limit > 0:
        if cfg.infer_scores:
            raise UsageError(
                "can't use --anyornone or --queryhsplimit with"
                " --infer[only]")
        if cfg.inner_threshold > 0:
            raise UsageError(
                "can't use --anyornone or --queryhsplimit with --inner")
        if cfg.segments_filename is not None:
            raise UsageError(
                "can't use --anyornone or --queryhsplimit with --segments")
        if cfg.hsp_threshold.t != "S":
            raise UsageError(
                "can't use --anyornone or --queryhsplimit with adaptive"
                " hsp score threshold")
        if cfg.target_is_quantum or cfg.query_is_quantum:
            raise UsageError(
                "can't use --anyornone or --queryhsplimit with quantum dna")

    # reconstruct the args string as the reference does (all args with
    # trailing spaces, file names removed)
    cfg.args = "".join(p + " " for p in args_parts)
    return cfg


def _fit_census_kind(cfg):
    """Pick a census counter width wide enough for the masking threshold
    (reference lastz.c:6560-6578)."""
    n = cfg.dynamic_masking
    if cfg.census_kind == "B" and n >= 255:
        cfg.census_kind = ""
    elif cfg.census_kind == "W" and n >= 65535:
        raise SystemExit("--census16 can't support --masking > %d" % 65534)
    if not cfg.census_kind:
        if n < 255:
            cfg.census_kind = "B"
        elif n < 65535:
            cfg.census_kind = "W"
        else:
            cfg.census_kind = "L"


def _set_gap(cfg, open_=None, extend=None):
    from .core.scoring import new_dna_score_set

    if cfg.scoring is None:
        cfg.scoring = new_dna_score_set()
    if open_ is not None:
        cfg.scoring.gap_open = open_
        cfg.scoring.gap_open_set = True
    if extend is not None:
        cfg.scoring.gap_extend = extend
        cfg.scoring.gap_extend_set = True


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    try:
        cfg = parse_options(argv)
    except UsageError as e:
        print(f"lastz_tpu: {e}", file=sys.stderr)
        return 1
    if cfg.seq1_filename is None and not cfg.read_capsule:
        print("usage: lastz_tpu target [query] [options]", file=sys.stderr)
        return 1
    from .pipeline import Pipeline

    out = sys.stdout
    close = False
    if getattr(cfg, "output_filename", None):
        out = open(cfg.output_filename, "w")
        close = True
    try:
        try:
            return _run(cfg, out)
        except ValueError as e:
            # user-facing input errors (missing contigs, bad subranges,
            # malformed files) exit like the reference's suicide()
            print(f"FAILURE: {e}", file=sys.stderr)
            return 1
        except OSError as e:
            # reference fopen_or_die (utilities.c)
            name = getattr(e, "filename", None)
            if name is None:
                raise
            print(f'FAILURE: fopen_or_die failed to open "{name}"'
                  f' for "rb"', file=sys.stderr)
            return 1
    finally:
        if close:
            out.close()


def _run(cfg, out):
    from .pipeline import Pipeline

    if cfg.infer_scores:
        from .infer import drive_scoring_inference
        inferred = drive_scoring_inference(
            cfg, cfg.infer_control_filename, cfg.infer_scores_filename)
        if cfg.infer_only:
            return 0
        cfg.scoring = inferred
        cfg.masked_scoring = None
    Pipeline(cfg, out).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
