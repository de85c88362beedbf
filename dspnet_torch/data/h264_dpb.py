"""The H.264 decoded picture buffer on the host (ITU-T H.264 8.2): picture
order counts, reference marking, reference lists, and the output order as
cv2's FFmpeg returns frames. It needs no pixels: :class:`Dpb` plans every
picture of a batch (its POC, its lists as picture ids, what it marks) before
the kernels run.

* POC types 0, 1 and 2 (8.2.1).
* Marking (8.2.5): IDR (with ``long_term_reference_flag``), the sliding
  window, and MMCO 1-4 and 6 with long-term references. MMCO 5 raises by
  name: FFmpeg's output order around it with reordered B frames is not
  followed (measured on a form; with P pictures only it was).
* Lists (8.2.4): P by descending PicNum then long-term, B by POC around the
  current picture then long-term (list 1's first two entries swapped when
  it equals list 0), truncated to ``num_ref_idx_active``, then modified by
  ``ref_pic_list_modification``.
* Output (:meth:`Dpb.add` / :meth:`Dpb.flush`): FFmpeg's
  ``h264_select_output_frame``: ``has_b_frames`` from the VUI's
  ``max_num_reorder_frames`` where ``bitstream_restriction_flag`` is set,
  else FFmpeg's heuristic over the last POCs ("Increasing reorder buffer");
  a picture whose POC precedes one already output is dropped, as FFmpeg
  drops it; at the end of the stream the delayed pictures come out in POC
  order, stopping at each IDR.

A ``frame_num`` gap the SPS allows is filled as FFmpeg fills it (a frame
copying the latest short-term reference for each missing frame_num, never
output); a gap it does not allow, a missing reference in a list or a list
modification naming no picture raise by name (FFmpeg would conceal them).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from dspnet_torch.data.h264_nal import B, I, P, H264Error

#: FFmpeg's H264_MAX_DPB_FRAMES and MAX_DELAYED_PIC_COUNT
MAX_DPB = 16
INT_MIN = -(1 << 31)


class Frame:
    """One decoded picture's bookkeeping."""

    def __init__(self, pid: int, frame_num: int, poc: int, key: bool):
        self.pid = pid
        self.frame_num = frame_num
        self.poc = poc
        self.key = key
        self.ref: Optional[str] = None  # None, "short" or "long"
        self.long_idx = -1
        self.mmco_reset = False
        self.slice_type = I
        #: the picture whose samples this one holds (a gap frame shares its
        #: source's buffer, and FFmpeg tells references apart by buffer)
        self.alias = pid

    def __repr__(self):
        return f"Frame(pid={self.pid}, fn={self.frame_num}, poc={self.poc}, ref={self.ref})"


class Dpb:
    """The decoded picture buffer of one stream."""

    def __init__(self):
        self.frames: List[Frame] = []  # reference pictures
        self.next_pid = 0
        self.max_long_idx = -1  # "no long-term frame indices"
        # POC state
        self.prev_msb = self.prev_lsb = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0
        self.prev_ref_frame_num = 0
        # output state
        self.has_b_frames = 0
        self.delayed: List[Frame] = []
        self.last_pocs = [INT_MIN] * MAX_DPB
        self.next_outputed_poc = INT_MIN
        self.seen = False

    # ------------------------------------------------------------ POC
    def poc(self, h) -> int:
        sps = h.sps
        max_fn = 1 << sps.log2_max_frame_num
        if sps.pic_order_cnt_type == 0:
            if h.idr:
                prev_msb, prev_lsb = 0, 0
            else:
                prev_msb, prev_lsb = self.prev_msb, self.prev_lsb
            max_lsb = 1 << sps.log2_max_poc_lsb
            lsb = h.poc_lsb
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
            top = msb + lsb
            bottom = top + h.delta_poc_bottom
            h.poc_msb = msb
            return min(top, bottom)
        if h.idr:
            offset = 0
        else:
            prev = self.prev_frame_num_offset
            offset = prev + max_fn if self.prev_frame_num > h.frame_num else prev
        h.frame_num_offset = offset
        if sps.pic_order_cnt_type == 2:
            if h.idr:
                return 0
            return 2 * (offset + h.frame_num) - (0 if h.nal_ref_idc else 1)
        cycle = sps.offset_for_ref_frame
        n = len(cycle)
        absn = offset + h.frame_num if n else 0
        if not h.nal_ref_idc and absn > 0:
            absn -= 1
        expected = 0
        if absn > 0:
            cnt, k = divmod(absn - 1, n)
            expected = cnt * sum(cycle) + sum(cycle[:k + 1])
        if not h.nal_ref_idc:
            expected += sps.offset_for_non_ref_pic
        top = expected + h.delta_poc[0]
        bottom = top + sps.offset_for_top_to_bottom_field + h.delta_poc[1]
        return min(top, bottom)

    # ------------------------------------------------------------ a picture
    def start(self, h) -> Tuple[Frame, List[Tuple[Frame, int]]]:
        """Begins the picture whose first slice header is ``h``: its POC,
        the IDR flush, and the frames a ``frame_num`` gap stands for ->
        (the picture, [(gap frame, id of the picture whose samples it
        copies)])."""
        sps = h.sps
        max_fn = 1 << sps.log2_max_frame_num
        gaps = []
        if h.idr:
            for f in self.frames:
                f.ref = None
            self.frames = []
            self.max_long_idx = -1
        elif not self.seen:
            raise H264Error("the stream starts without an IDR picture (FFmpeg conceals until one)")
        elif h.frame_num != self.prev_ref_frame_num and h.frame_num != (self.prev_ref_frame_num + 1) % max_fn:
            if not sps.gaps_in_frame_num_value_allowed_flag:
                raise H264Error(f"a gap in frame_num ({self.prev_ref_frame_num} -> {h.frame_num}) where the SPS "
                                "allows none: FFmpeg conceals the missing frames; the port does not read such a "
                                "stream")
            gaps = self._fill_gap(h.frame_num, max_fn, sps.max_num_ref_frames)
        self.seen = True
        poc = self.poc(h)
        f = Frame(self.next_pid, h.frame_num, poc, bool(h.idr))
        self.next_pid += 1
        f.slice_type = h.slice_type
        return f, gaps

    def _fill_gap(self, frame_num: int, max_fn: int, max_refs: int) -> List[Tuple[Frame, int]]:
        """FFmpeg's frames for a ``frame_num`` gap (8.2.5.2): each missing
        frame_num a short-term reference under the sliding window, holding
        the samples of the latest short-term reference and its POC + 2;
        never output. (Their motion is not defined: FFmpeg leaves it as
        its buffer pool hands it out.)"""
        out = []
        while (self.prev_ref_frame_num + 1) % max_fn != frame_num:
            prev = next((g for g in reversed(self.frames) if g.ref == "short"), None)
            if prev is None:
                raise H264Error("a gap in frame_num with no short-term reference to copy")
            g = Frame(self.next_pid, (self.prev_ref_frame_num + 1) % max_fn, prev.poc + 2, False)
            g.alias = prev.alias
            self.next_pid += 1
            self._slide(g, max_refs, max_fn)
            self.frames.append(g)
            self.prev_ref_frame_num = self.prev_frame_num = g.frame_num
            out.append((g, prev.pid))
        return out

    def _slide(self, f: Frame, max_refs: int, max_fn: int):
        """The sliding window (8.2.5.3) before ``f`` is marked short-term:
        at ``max_num_ref_frames`` references, the short-term one of the
        smallest FrameNumWrap is dropped."""
        refs = [g for g in self.frames if g.ref is not None]
        if len(refs) >= max(max_refs, 1):
            shorts = [g for g in refs if g.ref == "short"]
            if not shorts:
                raise H264Error("the sliding window finds no short-term reference to drop")
            min(shorts, key=lambda g: g.frame_num - max_fn if g.frame_num > f.frame_num else g.frame_num).ref = None
        self.frames = [g for g in self.frames if g.ref is not None]
        f.ref = "short"

    def pic_num(self, f: Frame, h) -> int:
        max_fn = 1 << h.sps.log2_max_frame_num
        return f.frame_num - max_fn if f.frame_num > h.frame_num else f.frame_num

    def lists(self, h) -> List[List[Frame]]:
        """RefPicList0 / 1 of one slice (8.2.4), as frames."""
        st = h.slice_type
        if st == I:
            return [[], []]
        short = [f for f in self.frames if f.ref == "short"]
        long = sorted((f for f in self.frames if f.ref == "long"), key=lambda f: f.long_idx)
        cur = h.poc
        if st == P:
            init = [sorted(short, key=lambda f: -self.pic_num(f, h)) + long, []]
        else:
            before = sorted((f for f in short if f.poc < cur), key=lambda f: -f.poc)
            after = sorted((f for f in short if f.poc > cur), key=lambda f: f.poc)
            l0, l1 = before + after + long, after + before + long
            if len(l1) > 1 and l1 == l0:
                l1[0], l1[1] = l1[1], l1[0]
            init = [l0, l1]
        out = []
        for lx in range(2 if st == B else 1):
            n = h.num_ref_idx[lx]
            lst: List[Optional[Frame]] = (init[lx] + [None] * n)[:n]
            max_fn = 1 << h.sps.log2_max_frame_num
            pred = h.frame_num
            idx = 0
            for idc, val in h.modification[lx]:
                if idc in (0, 1):
                    diff = val + 1
                    if idc == 0:
                        nowrap = pred - diff + (max_fn if pred - diff < 0 else 0)
                    else:
                        nowrap = pred + diff - (max_fn if pred + diff >= max_fn else 0)
                    pred = nowrap
                    num = nowrap - max_fn if nowrap > h.frame_num else nowrap
                    pic = next((f for f in short if self.pic_num(f, h) == num), None)
                    what = f"short-term PicNum {num}"
                else:
                    pic = next((f for f in long if f.long_idx == val), None)
                    what = f"long-term PicNum {val}"
                if pic is None:
                    raise H264Error(f"ref_pic_list_modification names a {what} the DPB does not hold")
                lst = lst[:idx] + [pic] + [f for f in lst[idx:] if f is not pic]
                lst = lst[:n]
                idx += 1
            if any(f is None for f in lst):
                raise H264Error(f"list {lx} of a slice has {sum(f is None for f in lst)} missing reference(s) "
                                f"(num_ref_idx_active {n}, the DPB holds {len(short) + len(long)}): FFmpeg conceals")
            out.append(lst)
        if st == P:
            out.append([])
        return out

    def mark(self, f: Frame, h, max_refs: int):
        """Reference marking after the picture (8.2.5)."""
        self.prev_frame_num = h.frame_num
        self.prev_frame_num_offset = h.frame_num_offset or 0
        if not h.nal_ref_idc:
            return
        if h.idr:
            if h.long_term_reference_flag:
                f.ref, f.long_idx, self.max_long_idx = "long", 0, 0
            else:
                f.ref, self.max_long_idx = "short", -1
        elif h.mmco:
            for op, a, b in h.mmco:
                if op == 1:
                    num = h.frame_num - (a + 1)
                    victim = next((g for g in self.frames if g.ref == "short" and self.pic_num(g, h) == num), None)
                    if victim is None:
                        raise H264Error(f"MMCO 1 names short-term PicNum {num}, which the DPB does not hold")
                    victim.ref = None
                elif op == 2:
                    victim = next((g for g in self.frames if g.ref == "long" and g.long_idx == a), None)
                    if victim is None:
                        raise H264Error(f"MMCO 2 names long-term PicNum {a}, which the DPB does not hold")
                    victim.ref = None
                elif op == 3:
                    num = h.frame_num - (a + 1)
                    pic = next((g for g in self.frames if g.ref == "short" and self.pic_num(g, h) == num), None)
                    if pic is None or b > self.max_long_idx:
                        raise H264Error(f"MMCO 3 on short-term PicNum {num} to LongTermFrameIdx {b}")
                    for g in self.frames:
                        if g.ref == "long" and g.long_idx == b:
                            g.ref = None
                    pic.ref, pic.long_idx = "long", b
                elif op == 4:
                    self.max_long_idx = a - 1
                    for g in self.frames:
                        if g.ref == "long" and g.long_idx > self.max_long_idx:
                            g.ref = None
                elif op == 5:
                    raise H264Error("memory_management_control_operation 5 (all references unused, POC reset) is not "
                                    "read: FFmpeg's output order around it with reordered frames is not followed")
                elif op == 6:
                    if b > self.max_long_idx:
                        raise H264Error(f"MMCO 6 to LongTermFrameIdx {b} above the maximum {self.max_long_idx}")
                    for g in self.frames:
                        if g.ref == "long" and g.long_idx == b:
                            g.ref = None
                    f.ref, f.long_idx = "long", b
            if f.ref is None:
                f.ref = "short"
        else:
            self._slide(f, max_refs, 1 << h.sps.log2_max_frame_num)
        self.frames = [g for g in self.frames if g.ref is not None]
        if f.ref is not None:
            self.frames.append(f)
        if len(self.frames) > max(max_refs, 1):
            raise H264Error(f"{len(self.frames)} reference frames with max_num_ref_frames {max_refs}")
        self.prev_ref_frame_num = f.frame_num
        if h.sps.pic_order_cnt_type == 0:
            self.prev_msb, self.prev_lsb = h.poc_msb, h.poc_lsb

    # ------------------------------------------------------------ output
    def add(self, f: Frame, sps) -> List[Frame]:
        """FFmpeg's ``h264_select_output_frame`` for the new picture ``f``:
        the pictures to output now (none or one)."""
        vui = sps.vui
        restrict = vui is not None and vui.bitstream_restriction_flag
        if f.key:
            self.last_pocs = [INT_MIN] * MAX_DPB
        if restrict:
            self.has_b_frames = max(self.has_b_frames, vui.max_num_reorder_frames)
        i = 0
        while True:
            if i == MAX_DPB or f.poc < self.last_pocs[i]:
                if i:
                    self.last_pocs[i - 1] = f.poc
                break
            elif i:
                self.last_pocs[i - 1] = self.last_pocs[i]
            i += 1
        out_of_order = MAX_DPB - i
        if f.slice_type == B or (self.last_pocs[MAX_DPB - 2] > INT_MIN and
                                 self.last_pocs[MAX_DPB - 1] - self.last_pocs[MAX_DPB - 2] > 2):
            out_of_order = max(out_of_order, 1)
        if out_of_order == MAX_DPB:
            self.last_pocs = [INT_MIN] * MAX_DPB
            self.last_pocs[0] = f.poc
            f.mmco_reset = True
        elif self.has_b_frames < out_of_order and not restrict:
            self.has_b_frames = out_of_order
        self.delayed.append(f)
        out, idx = self.delayed[0], 0
        for k in range(1, len(self.delayed)):
            g = self.delayed[k]
            if g.key or g.mmco_reset:
                break
            if g.poc < out.poc:
                out, idx = g, k
        if self.has_b_frames == 0 and (self.delayed[0].key or self.delayed[0].mmco_reset):
            self.next_outputed_poc = INT_MIN
        ooo = out.poc < self.next_outputed_poc
        pics = len(self.delayed)
        if ooo or pics > self.has_b_frames:
            del self.delayed[idx]
        if not ooo and pics > self.has_b_frames:
            if idx == 0 and self.delayed and (self.delayed[0].key or self.delayed[0].mmco_reset):
                self.next_outputed_poc = INT_MIN
            else:
                self.next_outputed_poc = out.poc
            return [out]
        return []

    def flush(self) -> List[Frame]:
        """The delayed pictures at the end of the stream, in FFmpeg's order."""
        out = []
        while self.delayed:
            best, idx = self.delayed[0], 0
            for k in range(1, len(self.delayed)):
                g = self.delayed[k]
                if g.key or g.mmco_reset:
                    break
                if g.poc < best.poc:
                    best, idx = g, k
            del self.delayed[idx]
            out.append(best)
        return out
