"""Cityscapes preparation (counterpart of
``dspnet_tpu/tools/prepare_cityscapes.py``; offline, on the host).

The reference's preparation chain, on the raw Cityscapes release:

  gtFine ``*_gtFine_polygons.json`` --json_to_xml--> PASCAL-style XML at the
  layout's scale (reference dataset/cs_json2xml.py:18-91)
  --inject_distances--> a ``<distance>`` per object from the median stereo
  disparity inside its box: 2200 * 75 / median, over 1000 -> 200 m
  (reference data/cityscapes/disparity2distance.py:42-82);
  the polygons --fill_poly--> the trainId PNG and the 16-bit instanceIds PNG
  (the vendored json2labelImg / json2instanceImg scripts); the raw
  disparity --nearest resize--> ``Disparity/`` at the layout's scale
  (resize_disparity.sh); ``ImageSets/Main/{split}.txt``.

Every output equals the JAX tool's: the XML text byte for byte, the PNGs as
arrays (``tests/test_torch_tools.py``). cv2's ``fillPoly`` is
``utils/raster.py::fill_poly`` here and its PNG reads and writes are
``data/image_io.py``'s. The images themselves (``JPEGImages/``) come from
the reference's ``convert_cityscapes.sh``, as they do for the JAX tool.

    python -m dspnet_torch.tools.prepare_cityscapes --gtfine gtFine \\
        --disparity disparity --out cityscapes --split train --instance-ids
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import xml.etree.ElementTree as ET
from xml.dom import minidom

import numpy as np

from dspnet_torch.data import image_io
from dspnet_torch.data.cs_labels import name2label
from dspnet_torch.utils.raster import fill_poly

DISPARITY_SCALE = 2200.0 * 75.0


def _load_polygons(json_path: str, parsed: dict | None = None) -> dict:
    if parsed is not None:
        return parsed
    with open(json_path) as f:
        return json.load(f)


def json_to_xml(json_path: str, xml_path: str | None = None, scale: float = 0.5,
                parsed: dict | None = None) -> str:
    """Polygon JSON -> PASCAL-style XML with polygon-extent boxes, at
    ``scale`` resolution (the reference halves, cs_json2xml.py:38,67)."""
    parsed = _load_polygons(json_path, parsed)
    if xml_path is None:
        xml_path = json_path.replace(".json", ".xml")

    top = ET.Element("annotation")
    ET.SubElement(top, "filename").text = os.path.basename(
        json_path.replace("json", "jpg")
    ).replace("gtFine_polygons", "leftImg8bit")
    ET.SubElement(top, "folder").text = "cityscapes"
    size = ET.SubElement(top, "size")
    h = int(round(parsed["imgHeight"] * scale))
    w = int(round(parsed["imgWidth"] * scale))
    ET.SubElement(size, "height").text = str(h)
    ET.SubElement(size, "width").text = str(w)
    ET.SubElement(size, "depth").text = "3"

    for idval, label in enumerate(parsed["objects"]):
        obj = ET.SubElement(top, "object")
        ET.SubElement(obj, "name").text = label["label"]
        ET.SubElement(obj, "difficult").text = "0"
        ET.SubElement(obj, "id").text = str(idval)
        # the reference's Python-2 int(round(p/2)) floors (the integer
        # division happens first, cs_json2xml.py:67), negative coordinates
        # included: Cityscapes polygons reach past the image border
        xs = [math.floor(p[0] * scale) for p in label["polygon"]]
        ys = [math.floor(p[1] * scale) for p in label["polygon"]]
        bnd = ET.SubElement(obj, "bndbox")
        ET.SubElement(bnd, "xmin").text = str(min(xs))
        ET.SubElement(bnd, "xmax").text = str(max(xs))
        ET.SubElement(bnd, "ymin").text = str(min(ys))
        ET.SubElement(bnd, "ymax").text = str(max(ys))

    with open(xml_path, "w") as f:
        f.write(minidom.parseString(ET.tostring(top, "utf-8")).toprettyxml())
    return xml_path


def disparity_to_distance(disparity_roi: np.ndarray) -> float:
    """Median disparity -> metres (disparity2distance.py:62-68)."""
    roi = np.sort(disparity_roi.astype(np.float32).reshape(-1))
    if roi.shape[0] == 0:
        return 200.0
    # the reference's ceil(n/2) runs under Python-2 integer division, so the
    # index is n//2 (disparity2distance.py:67), in bounds for a 1-pixel ROI
    dist = DISPARITY_SCALE / (roi[roi.shape[0] // 2] + 1e-3)
    return 200.0 if dist > 1000 else float(dist)


def inject_distances(xml_path: str, disparity_path: str, class_names) -> None:
    """Add or replace ``<distance>`` on each named object
    (disparity2distance.py:55-82)."""
    tree = ET.parse(xml_path)
    root = tree.getroot()
    disparity = image_io.imread(disparity_path, image_io.IMREAD_UNCHANGED)
    for obj in root.findall("object"):
        if obj.find("name").text not in class_names:
            continue
        bnd = obj.find("bndbox")
        xmin = max(0, int(bnd.find("xmin").text))
        xmax = int(bnd.find("xmax").text)
        ymin = max(0, int(bnd.find("ymin").text))
        ymax = int(bnd.find("ymax").text)
        if xmin == xmax:
            xmax = xmin + 1
        dist = disparity_to_distance(disparity[ymin:ymax, xmin:xmax])
        for tag in obj.findall("distance"):
            obj.remove(tag)
        ET.SubElement(obj, "distance").text = str(int(round(dist)))
    tree.write(xml_path)


def resize_disparity(src_path: str, dst_path: str, scale: float = 0.5) -> str:
    """Nearest-resize a raw disparity PNG to the annotation scale (the
    reference's resize_disparity.sh into ``Disparity/``): the scaled
    annotations index into it (disparity2distance.py:52-64), and evaluation
    reads it for the depth metric."""
    disparity = image_io.imread(src_path, image_io.IMREAD_UNCHANGED)
    h = int(round(disparity.shape[0] * scale))
    w = int(round(disparity.shape[1] * scale))
    image_io.imwrite(dst_path, image_io.resize_nearest(disparity, (h, w)))
    return dst_path


def _iter_polygons(json_path: str, scale: float = 1.0, parsed: dict | None = None):
    """((h, w), [(label, pts (n, 1, 2) int32, is_group)]) for each drawable
    polygon at ``scale``: '...group' names resolved, deleted and unknown
    labels skipped (the object loop of json2labelImg / json2instanceImg)."""
    parsed = _load_polygons(json_path, parsed)
    polys = []
    for obj in parsed["objects"]:
        if obj.get("deleted", 0):
            continue
        name = obj["label"]
        is_group = False
        if name not in name2label and name.endswith("group"):
            name = name[: -len("group")]
            is_group = True
        if name not in name2label:
            continue
        # floor, not truncation: negative border coordinates follow the
        # reference's Python-2 integer division
        pts = np.floor(np.asarray(obj["polygon"], np.float64) * scale).astype(np.int32).reshape(-1, 1, 2)
        polys.append((name2label[name], pts, is_group))
    h = int(round(parsed["imgHeight"] * scale))
    w = int(round(parsed["imgWidth"] * scale))
    return (h, w), polys


def polygons_to_trainid_png(json_path: str, out_path: str, scale: float = 1.0,
                            parsed: dict | None = None) -> str:
    """Rasterise polygon JSON to a trainId label PNG (json2labelImg).
    ``scale`` must match the images the mask trains against."""
    (h, w), polys = _iter_polygons(json_path, scale, parsed)
    out = np.full((h, w), 255, np.uint8)  # unlabeled -> ignore
    for label, pts, _ in polys:
        tid = label.trainId
        fill_poly(out, pts, 255 if tid < 0 or tid == 255 else tid)
    image_io.imwrite(out_path, out)
    return out_path


def polygons_to_instanceid_png(json_path: str, out_path: str, encoding: str = "ids",
                               scale: float = 1.0, parsed: dict | None = None) -> str:
    """Rasterise polygon JSON to a 16-bit instanceIds PNG (json2instanceImg,
    the official gtFine ``*_instanceIds.png`` format).

    Classes with ``hasInstances`` get ``class_id * 1000 + n`` per polygon
    (a running number per class); '...group' polygons and classes without
    instances get the bare class id; negative ids are not drawn but take
    their instance number. Background is 'unlabeled'. With
    ``encoding='trainIds'`` an ignored class (trainId 255) keeps the bare
    255, as in the JAX tool (a 16-bit PNG cannot hold 255 * 1000 + n)."""
    (h, w), polys = _iter_polygons(json_path, scale, parsed)
    tid = encoding == "trainIds"
    background = name2label["unlabeled"].trainId if tid else name2label["unlabeled"].id
    out = np.full((h, w), max(background, 0), np.int32)
    counts: dict[str, int] = {}
    for label, pts, is_group in polys:
        val = label.trainId if tid else label.id
        if label.hasInstances and not is_group:
            if not (tid and val >= 255):
                val = val * 1000 + counts.get(label.name, 0)
            counts[label.name] = counts.get(label.name, 0) + 1
        if val < 0:
            continue
        fill_poly(out, pts, val)
    image_io.imwrite(out_path, out.astype(np.uint16))
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description="Prepare Cityscapes for dspnet_torch.")
    p.add_argument("--gtfine", required=True, help="gtFine root (with */*.json)")
    p.add_argument("--disparity", default="", help="disparity root (optional)")
    p.add_argument("--out", required=True, help="output dataset root")
    p.add_argument("--split", default="train")
    p.add_argument("--scale", type=float, default=0.5,
                   help="resolution scale of the prepared layout relative to the raw 2048x1024 "
                        "(the reference halves everything; images, XML boxes, seg masks and "
                        "disparity must share one resolution)")
    p.add_argument("--classes", default="person,rider,car,truck,bus,train,motorcycle,bicycle")
    p.add_argument("--instance-ids", action="store_true",
                   help="also rasterise *_gtFine_instanceIds.png (for the instance-level evaluator)")
    args = p.parse_args(argv)
    classes = args.classes.split(",")
    dirs = ["Annotations", "SegmentationClass", os.path.join("ImageSets", "Main")]
    for d in dirs + (["SegmentationInstance"] if args.instance_ids else []):
        os.makedirs(os.path.join(args.out, d), exist_ok=True)
    ids = []
    for jp in sorted(glob.glob(os.path.join(args.gtfine, args.split, "*", "*_gtFine_polygons.json"))):
        stem = os.path.basename(jp).replace("_gtFine_polygons.json", "")
        with open(jp) as f:  # parsed once; three rasterisers share it
            parsed = json.load(f)
        xml_path = os.path.join(args.out, "Annotations", stem + "_leftImg8bit.xml")
        json_to_xml(jp, xml_path, scale=args.scale, parsed=parsed)
        polygons_to_trainid_png(
            jp, os.path.join(args.out, "SegmentationClass", stem + "_gtFine_labelTrainIds.png"),
            scale=args.scale, parsed=parsed)
        if args.instance_ids:
            polygons_to_instanceid_png(
                jp, os.path.join(args.out, "SegmentationInstance", stem + "_gtFine_instanceIds.png"),
                scale=args.scale, parsed=parsed)
        if args.disparity:
            dp = os.path.join(args.disparity, args.split, stem.split("_")[0], stem + "_disparity.png")
            if os.path.exists(dp):
                # resized to the XML's frame first, and kept for the depth metric
                os.makedirs(os.path.join(args.out, "Disparity"), exist_ok=True)
                half = resize_disparity(dp, os.path.join(args.out, "Disparity", stem + "_disparity.png"),
                                        scale=args.scale)
                inject_distances(xml_path, half, classes)
        ids.append(stem + "_leftImg8bit")
    with open(os.path.join(args.out, "ImageSets", "Main", args.split + ".txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    print(f"prepared {len(ids)} annotations under {args.out}")


if __name__ == "__main__":
    main()
