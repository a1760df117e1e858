# Copied from kmer_denovo_filter_tpu/kraken2.py
"""Kraken2 taxonomic classification stage (optional VCF-mode annotation).

Behavioural port of the reference's Kraken2Runner
(reference kmer_utils.py:252–1034): wraps the ``kraken2`` binary in a
subprocess, parses its per-read output, loads the NCBI taxonomy
(nodes.dmp/names.dmp) for lineage-aware domain sets, applies the human
homology guard and UniVec Core exclusion, and maintains the four-way
read partition NHF + UCF + HLF + UF = 1.

This stage stays host-side by design: it is an optional annotation
step bounded by the (small) informative-read set, and the Kraken2 LCA
database is an external mmap'd artifact.  SURVEY.md §2.2 marks a
device LCA classifier as a possible later extension.
"""

import logging
import os
import subprocess
import tempfile
import threading
import time

logger = logging.getLogger(__name__)

# NCBI taxonomy IDs for the major clades.
BACTERIA_TAXID = 2
ARCHAEA_TAXID = 2157
FUNGI_TAXID = 4751
EUKARYOTA_TAXID = 2759
METAZOA_TAXID = 33208
VIRIDIPLANTAE_TAXID = 33090
VIRUSES_TAXID = 10239
HUMAN_TAXID = 9606
# UniVec Core: synthetic sequencing-vector/adapter sequences — never
# counted as biological non-human content.
UNIVEC_CORE_TAXID = 81077

_HEARTBEAT_INTERVAL = 30
_HEARTBEAT_JOIN_TIMEOUT = 2

# Clade tally categories, in domain-label precedence order.  "protist"
# has no single root taxid (it is Eukaryota minus three sub-clades, see
# load_all_taxid_sets) so its root is None.
_CLADES = (
    ("bacterial", "Bacteria", BACTERIA_TAXID),
    ("archaeal", "Archaea", ARCHAEA_TAXID),
    ("fungal", "Fungi", FUNGI_TAXID),
    ("protist", "Protist", None),
    ("viral", "Viruses", VIRUSES_TAXID),
    ("univec_core", "UniVec_Core", UNIVEC_CORE_TAXID),
)
# Every per-read-name tally a Kraken2Result carries: the clades above
# plus the nonhuman/human-lineage split.
TALLY_CATEGORIES = tuple(c[0] for c in _CLADES) + (
    "nonhuman", "human_lineage")


def _read_proc_rss_kb(pid):
    try:
        with open(f"/proc/{pid}/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class Kraken2Result:
    """Tallied outcome of one classification run.

    The four read-name sets ``nonhuman`` / ``univec_core`` /
    ``human_lineage`` / ``unclassified`` partition all processed reads,
    so the per-variant fractions built from them sum to 1.

    Attribute surface matches the reference Result
    (reference kmer_utils.py:337–463): ``{category}_count`` plus
    ``{category}_read_names`` per tally category, the
    total/classified/unclassified counters, human/root counts, and
    ``per_read_detail``.
    """

    def __init__(self):
        for counter in ("total", "classified", "unclassified",
                        "human_count", "root_count"):
            setattr(self, counter, 0)
        for cat in TALLY_CATEGORIES:
            setattr(self, f"{cat}_count", 0)
            setattr(self, f"{cat}_read_names", set())
        self.unclassified_read_names = set()
        self.per_read_detail = {}

    def record(self, category, read_name):
        """Count *read_name* under one tally category."""
        getattr(self, f"{category}_read_names").add(read_name)
        setattr(self, f"{category}_count",
                getattr(self, f"{category}_count") + 1)

    def summary(self):
        def pct(n):
            return f"{100 * n / self.total:.1f}" if self.total > 0 else "0.0"

        return ", ".join([
            f"kraken2: {self.total} reads",
            f"{self.classified} classified",
            f"{self.bacterial_count} bacterial ({pct(self.bacterial_count)}%)",
            f"{self.archaeal_count} archaeal",
            f"{self.fungal_count} fungal",
            f"{self.protist_count} protist",
            f"{self.viral_count} viral",
            f"{self.univec_core_count} univec_core",
            f"{self.nonhuman_count} non-human ({pct(self.nonhuman_count)}%)",
            f"{self.human_count} human",
            f"{self.root_count} root",
        ])

    @property
    def bacterial_fraction(self):
        if self.total == 0:
            return 0.0
        return round(self.bacterial_count / self.total, 4)


class Kraken2Runner:
    """Subprocess driver + taxonomy logic for kraken2 classification."""

    Result = Kraken2Result

    def __init__(self, db_path, *, confidence=0.0, threads=1,
                 memory_mapping=False):
        self.db_path = db_path
        self.confidence = confidence
        self.threads = threads
        self.memory_mapping = memory_mapping

    # ── database introspection ─────────────────────────────────────

    @staticmethod
    def read_kmer_length(db_path):
        """k-mer length from opts.k2d (first size_t of IndexOptions).

        Looks in *db_path* and one directory level deeper (PrackenDB
        extracts into a versioned subdirectory).
        """
        search = [db_path]
        try:
            search += [e.path for e in os.scandir(db_path) if e.is_dir()]
        except OSError:
            pass
        for opts_path in (os.path.join(d, "opts.k2d") for d in search):
            try:
                with open(opts_path, "rb") as fh:
                    header = fh.read(8)
            except OSError:
                continue
            if len(header) < 8:
                continue
            k = int.from_bytes(header, "little")
            if 1 <= k <= 256:
                return k
        return None

    # ── taxonomy loading ───────────────────────────────────────────

    @staticmethod
    def _find_dump_file(db_path, filename):
        """NCBI dump file under ``taxonomy/`` or the DB root, or None."""
        for candidate in (os.path.join(db_path, "taxonomy", filename),
                          os.path.join(db_path, filename)):
            if os.path.isfile(candidate):
                return candidate
        return None

    @staticmethod
    def load_parent_map(db_path):
        """{child: parent} from nodes.dmp (taxonomy/ or db root)."""
        nodes_path = Kraken2Runner._find_dump_file(db_path, "nodes.dmp")
        if nodes_path is None:
            return None
        try:
            with open(nodes_path) as fh:
                rows = (line.split("\t|\t") for line in fh)
                return {int(row[0]): int(row[1])
                        for row in rows if len(row) >= 3}
        except (OSError, ValueError):
            return None

    @staticmethod
    def load_name_map(db_path):
        """{taxid: scientific_name} from names.dmp (spaces→underscores)."""
        names_path = Kraken2Runner._find_dump_file(db_path, "names.dmp")
        if names_path is None:
            logger.warning(
                "names.dmp not found under %s; taxon names will be "
                "unavailable in the per-read detail file.", db_path)
            return None
        name_map = {}
        try:
            with open(names_path) as fh:
                for line in fh:
                    row = line.split("\t|\t")
                    # keep only well-formed "scientific name" rows with
                    # an integer taxid in the first column
                    if (len(row) < 4 or row[3].replace("\t|", "").strip()
                            != "scientific name"):
                        continue
                    try:
                        name_map[int(row[0])] = (
                            row[1].strip().replace(" ", "_"))
                    except ValueError:
                        continue
        except OSError:
            return None
        return name_map

    # Backward-compat private aliases (reference API names)
    _load_parent_map = load_parent_map
    _load_name_map = load_name_map

    @staticmethod
    def descendants_of(parent_map, root_taxid):
        """All taxids whose lineage passes through *root_taxid*."""
        members = set()
        non_members = set()
        for start in parent_map:
            path = []
            cur = start
            while True:
                if cur in members or cur == root_taxid:
                    members.update(path)
                    members.add(cur)
                    break
                if (cur in non_members or cur in (0, 1)
                        or cur not in parent_map):
                    non_members.update(path)
                    non_members.add(cur)
                    break
                path.append(cur)
                cur = parent_map[cur]
        return members

    @staticmethod
    def ancestors_of(parent_map, taxid):
        """Lineage from *taxid* to root, inclusive."""
        ancestors = set()
        cur = taxid
        while cur in parent_map:
            ancestors.add(cur)
            parent = parent_map[cur]
            if parent == cur:
                break
            cur = parent
        return ancestors

    _descendants_of = descendants_of
    _ancestors_of = ancestors_of

    @staticmethod
    def load_all_taxid_sets(db_path):
        """Domain descendant sets + human lineage/clade sets.

        ``protist`` = Eukaryota − Metazoa − Fungi − Viridiplantae.
        Returns None when nodes.dmp is unavailable.
        """
        parent_map = Kraken2Runner.load_parent_map(db_path)
        if parent_map is None:
            return None
        d = Kraken2Runner.descendants_of
        bacterial = d(parent_map, BACTERIA_TAXID)
        archaeal = d(parent_map, ARCHAEA_TAXID)
        fungal = d(parent_map, FUNGI_TAXID)
        eukaryota = d(parent_map, EUKARYOTA_TAXID)
        metazoa = d(parent_map, METAZOA_TAXID)
        viridiplantae = d(parent_map, VIRIDIPLANTAE_TAXID)
        return {
            "bacterial": bacterial,
            "archaeal": archaeal,
            "fungal": fungal,
            "protist": eukaryota - metazoa - fungal - viridiplantae,
            "viral": d(parent_map, VIRUSES_TAXID),
            "univec_core": d(parent_map, UNIVEC_CORE_TAXID),
            "human_lineage": Kraken2Runner.ancestors_of(
                parent_map, HUMAN_TAXID),
            "human_clade": d(parent_map, HUMAN_TAXID),
        }

    _load_all_taxid_sets = load_all_taxid_sets

    @staticmethod
    def _load_bacterial_taxids(db_path):
        parent_map = Kraken2Runner.load_parent_map(db_path)
        if parent_map is None:
            return None
        return Kraken2Runner.descendants_of(parent_map, BACTERIA_TAXID)

    @staticmethod
    def extract_taxids_from_kmer_string(kmer_string):
        """Integer taxids from the kraken2 per-read k-mer detail field."""
        found = set()
        for token in (kmer_string or "").replace("|:|", " ").split():
            head = token.split(":", 1)[0]
            try:
                found.add(int(head))
            except ValueError:
                pass
        return found

    _extract_taxids_from_kmer_string = extract_taxids_from_kmer_string

    # ── classification ─────────────────────────────────────────────

    def classify_sequences(self, sequences, tmpdir=None):
        """Classify named sequences; returns a :class:`Kraken2Result`.

        *sequences* is a ``{name: seq}`` dict or ``(name, seq)`` list.
        Subprocess failure degrades gracefully to an empty result with
        a warning (reference kmer_utils.py:854–860).
        """
        result = Kraken2Result()
        items = list(sequences.items() if isinstance(sequences, dict)
                     else sequences)
        result.total = len(items)
        if not result.total:
            return result

        kmer_len = self.read_kmer_length(self.db_path)
        if kmer_len is None:
            logger.debug(
                "[Kraken2] could not read k-mer length from opts.k2d "
                "(db_path: %s)", self.db_path)
        else:
            logger.info("[Kraken2] database k-mer length: %d", kmer_len)

        fd, fastq_path = tempfile.mkstemp(
            suffix=".fq", prefix="kraken2_", dir=tmpdir)
        try:
            with os.fdopen(fd, "w") as fh:
                for name, seq in items:
                    fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")

            cmd = [
                "kraken2",
                "--db", self.db_path,
                "--threads", str(self.threads),
                "--confidence", str(self.confidence),
                "--output", "/dev/stdout",
                "--report", "/dev/null",
            ]
            if self.memory_mapping:
                cmd.append("--memory-mapping")
            cmd.append(fastq_path)

            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE)

            kraken2_start = time.monotonic()
            stop_heartbeat = threading.Event()

            def _heartbeat():
                while not stop_heartbeat.wait(_HEARTBEAT_INTERVAL):
                    rss = _read_proc_rss_kb(proc.pid)
                    elapsed = time.monotonic() - kraken2_start
                    if rss is not None:
                        logger.info(
                            "[Kraken2] heartbeat — %.0f s elapsed, "
                            "RSS: %.1f GB", elapsed, rss / 1_048_576)
                    else:
                        logger.info(
                            "[Kraken2] heartbeat — %.0f s elapsed "
                            "(memory info unavailable)", elapsed)

            hb = threading.Thread(target=_heartbeat, daemon=True,
                                  name="kraken2-heartbeat")
            hb.start()
            try:
                stdout, stderr = proc.communicate()
            finally:
                stop_heartbeat.set()
                hb.join(timeout=_HEARTBEAT_JOIN_TIMEOUT)

            elapsed = time.monotonic() - kraken2_start
            if proc.returncode != 0:
                logger.warning(
                    "kraken2 exited with code %d after %.0f s: %s",
                    proc.returncode, elapsed,
                    stderr.decode(errors="replace").strip()[:500])
                return result

            logger.info(
                "[Kraken2] classification complete — %d reads in %.0f s",
                result.total, elapsed)

            taxid_sets = self.load_all_taxid_sets(self.db_path)
            if taxid_sets is None:
                logger.warning(
                    "Kraken2 taxonomy lineage matching is unavailable "
                    "(missing/unreadable taxonomy/nodes.dmp under DB: "
                    "%s). Falling back to exact taxid matching only; "
                    "non-human fractions may be severely undercounted.",
                    self.db_path)

            self._tally_output(
                stdout.decode(errors="replace"), taxid_sets, result)
        finally:
            try:
                os.unlink(fastq_path)
            except OSError:
                pass
        return result

    @staticmethod
    def _classify_taxid(taxid, taxid_sets):
        """Pre-guard verdict for one LCA taxid.

        Returns ``(clades, is_human, in_human_lineage, is_nonhuman)``
        where *clades* is the set of clade category names (from
        ``_CLADES``) whose descendant set contains *taxid*.  Without a
        loaded taxonomy only exact root-taxid matches count and the
        human lineage is unknowable (empty).
        """
        if taxid_sets is not None:
            clades = {cat for cat, _label, _root in _CLADES
                      if taxid in taxid_sets[cat]}
            is_human = taxid in taxid_sets["human_clade"]
            in_lineage = taxid in taxid_sets["human_lineage"]
            nonhuman = not (is_human or in_lineage
                            or "univec_core" in clades)
            return clades, is_human, in_lineage, nonhuman
        clades = {cat for cat, _label, root in _CLADES if taxid == root}
        is_human = taxid == HUMAN_TAXID
        nonhuman = taxid not in (HUMAN_TAXID, 1, UNIVEC_CORE_TAXID)
        return clades, is_human, False, nonhuman

    @staticmethod
    def _domain_label(clades, is_human, in_lineage, taxid):
        """Pre-guard domain label, in ``_CLADES`` precedence order."""
        for cat, label, _root in _CLADES:
            if cat in clades:
                return label
        if is_human:
            return "Human"
        if in_lineage and taxid != 1:
            return "Ambiguous_Ancestor"
        return "Root"

    @staticmethod
    def _read_detail(status, taxid, domain, guard, nonhuman,
                     kmer_string):
        return {"status": status, "taxid": taxid, "domain": domain,
                "guard_status": guard, "is_nonhuman": nonhuman,
                "kmer_string": kmer_string}

    def _tally_output(self, text, taxid_sets, result):
        """Parse ``C/U\\tname\\ttaxid\\tlen\\tkmers`` lines into *result*."""
        for raw_line in text.split("\n"):
            fields = raw_line.strip().split("\t")
            if len(fields) < 3:
                continue
            status, read_name = fields[0], fields[1]
            try:
                taxid = int(fields[2])
            except ValueError:
                continue

            if status == "U":
                result.unclassified += 1
                result.unclassified_read_names.add(read_name)
                result.per_read_detail[read_name] = self._read_detail(
                    "U", 0, "Unclassified", "UNCLASSIFIED", False, "")
                continue

            result.classified += 1
            kmer_string = fields[4] if len(fields) >= 5 else ""
            clades, is_human, in_lineage, nonhuman = self._classify_taxid(
                taxid, taxid_sets)
            # Domain label is decided before the guard clears flags.
            domain = self._domain_label(clades, is_human, in_lineage,
                                        taxid)

            # Human homology guard: any human k-mer vote clears all
            # non-human category flags for this read.
            human_kmer_vote = HUMAN_TAXID in (
                self.extract_taxids_from_kmer_string(kmer_string))
            if human_kmer_vote:
                clades = set()
                nonhuman = False

            if is_human:
                guard = "HUMAN"
            elif human_kmer_vote:
                guard = "HHG"
            elif domain == "UniVec_Core":
                guard = "UVC"
            else:
                guard = "PASS"

            for cat, _label, _root in _CLADES:
                if cat in clades:
                    result.record(cat, read_name)
            if nonhuman:
                result.record("nonhuman", read_name)
            elif "univec_core" not in clades:
                result.record("human_lineage", read_name)
            if is_human:
                result.human_count += 1
            elif taxid == 1:
                result.root_count += 1

            result.per_read_detail[read_name] = self._read_detail(
                status, taxid, domain, guard, nonhuman, kmer_string)


def run_kraken2_on_reads(child_bam, ref_fasta, read_names, kraken2_db,
                         confidence=0.0, threads=1, tmpdir=None,
                         informative_reads_by_variant=None,
                         memory_mapping=False):
    """Fetch informative reads and classify them with kraken2.

    Prefers targeted locus fetches (reference vcf/pipeline.py:106–142)
    over a whole-file scan.
    """
    from kmer_denovo_filter_tpu_torch.htsio.bam import open_bam

    if not read_names:
        return Kraken2Result()

    sequences = {}
    bam = open_bam(child_bam, reference_filename=ref_fasta)
    used_targeted_fetch = False
    if informative_reads_by_variant:
        loci_to_names = {}
        for var_key, names in informative_reads_by_variant.items():
            if not names:
                continue
            parts = var_key.split(":")
            if len(parts) < 2:
                logger.warning(
                    "[Kraken2] Skipping malformed variant key "
                    "(missing ':'): %s", var_key)
                continue
            try:
                pos = int(parts[1])
            except ValueError:
                logger.warning(
                    "[Kraken2] Skipping malformed variant key "
                    "(non-integer pos): %s", var_key)
                continue
            target = set(names).intersection(read_names)
            if target:
                loci_to_names.setdefault(
                    (parts[0], pos), set()).update(target)
        if loci_to_names:
            used_targeted_fetch = True
            for (chrom, pos), target in sorted(loci_to_names.items()):
                for read in bam.fetch(chrom, pos, pos + 1):
                    if (read.query_name in target
                            and read.query_sequence
                            and read.query_name not in sequences):
                        sequences[read.query_name] = read.query_sequence

    if not used_targeted_fetch:
        for read in bam.fetch(until_eof=True):
            if read.query_name in read_names and read.query_sequence:
                if read.query_name not in sequences:
                    sequences[read.query_name] = read.query_sequence
    bam.close()

    if not sequences:
        return Kraken2Result()

    kr = Kraken2Runner(kraken2_db, confidence=confidence, threads=threads,
                       memory_mapping=memory_mapping)
    return kr.classify_sequences(sequences, tmpdir=tmpdir)
